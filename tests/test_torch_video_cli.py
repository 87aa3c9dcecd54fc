"""The port's Nx video CLI (`gimmvfi_tpu_torch.cli.video_nx`) on the CPU.

  * `interpolate_pair` at 120x176 (padded to 128x192) against the JAX CLI's
    `interpolate_pair`, both loading the same reference-layout `.pt` (a
    `state_dict` wrapper, `module.` prefixes, `g_filter` and
    `num_batches_tracked` keys): the JAX package through its own
    `load_torch_state_dict` + `convert_gimmvfi_r`, the port through
    `load_reference_state_dict`; >= 60 dB on the frames;
  * `main` end to end on PPM frames, counting the frames written, with cv2
    and without it (PPM frames in `<video>.frames/`);
  * the reference's extra keys (R and F) load strictly; an unknown or a
    missing key raises and is named; an orbax path is refused.
"""

import os
import sys

import numpy as np
import pytest
import torch

from gimmvfi_tpu.cli import video_nx as jax_video_nx
from gimmvfi_tpu_torch.cli import video_nx
from gimmvfi_tpu_torch.data.frame_io import read_ppm, write_ppm
from gimmvfi_tpu_torch.models.gimmvfi_f import GIMMVFI_F
from gimmvfi_tpu_torch.models.gimmvfi_r import GIMMVFI_R
from gimmvfi_tpu_torch.nn.layers import init_normal_
from gimmvfi_tpu_torch.utils.convert import load_reference_state_dict

torch.set_num_threads(1)


def reference_layout(sd: dict) -> dict:
    """A port state dict dressed as a reference training checkpoint."""
    out = {f"module.{k}": v for k, v in sd.items()}
    out["module.g_filter"] = torch.ones(1, 1, 3, 3) / 9
    for k in sd:
        if k.endswith("running_mean"):
            out[f"module.{k[:-len('running_mean')]}num_batches_tracked"] = torch.tensor(7)
    return {"state_dict": out, "epoch": 3}


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    model = init_normal_(GIMMVFI_R(raft_iters=2, device="cpu"), 11)
    path = str(tmp_path_factory.mktemp("ckpt") / "gimmvfi_r_random.pt")
    torch.save(reference_layout(model.state_dict()), path)
    return path


def _frames(seed, hw, k):
    rng = np.random.default_rng(seed)
    base = rng.random((hw[0] + 8, hw[1] + 8, 3)).astype(np.float32)
    # a shifted crop per frame: motion for the flow to find
    return [np.ascontiguousarray(base[2 * i: 2 * i + hw[0], 3 * i: 3 * i + hw[1]]) for i in range(k)]


def _psnr(a, b):
    mse = float(((a - b) ** 2).mean())
    return float("inf") if mse == 0 else 10 * np.log10(1.0 / mse)


def test_interpolate_pair_matches_jax(ckpt):
    img0, img1 = _frames(0, (120, 176), 2)
    jax_model, variables = jax_video_nx.load_model(ckpt, "gimmvfi_r", 2)
    ref_frames, ref_flows = jax_video_nx.interpolate_pair(jax_model, variables, img0, img1, 4, 1.0)
    model = video_nx.load_model(ckpt, "gimmvfi_r", 2, device="cpu")
    frames, flows = video_nx.interpolate_pair(model, img0, img1, 4, 1.0)
    assert len(frames) == len(ref_frames) == 3
    for got, want in zip(frames, ref_frames):
        assert got.shape == want.shape == (120, 176, 3)
        assert _psnr(got, want) >= 60.0
    for got, want in zip(flows, ref_flows):
        assert got.shape == want.shape == (120, 176, 2)
        assert np.abs(got - want).max() <= 1e-4 * max(1.0, float(np.abs(want).max()))


def _write_source(tmp_path, hw, k):
    src = tmp_path / "frames"
    src.mkdir()
    for i, f in enumerate(_frames(1, hw, k)):
        write_ppm(str(src / f"{i:03d}.ppm"), (f * 255).astype(np.uint8))
    return str(src)


@pytest.mark.parametrize("with_cv2", [True, False])
def test_main_end_to_end(ckpt, tmp_path, monkeypatch, capsys, with_cv2):
    src = _write_source(tmp_path, (128, 128), 3)
    out_dir = str(tmp_path / "out")
    if not with_cv2:
        monkeypatch.setitem(sys.modules, "cv2", None)
    res = video_nx.main(["--source-path", src, "--output-path", out_dir, "--N", "3",
                         "--ckpt", ckpt, "--device", "cpu"])
    n_frames = 1 + 2 * 3  # the first frame, then each pair's 2 timesteps and its hold frame
    assert len(res["frames"]) == n_frames and len(res["flows"]) == 2 * 2
    assert len(res["pair_ms"]) == 2
    assert all(f.shape == (128, 256, 3) and f.dtype == np.uint8 for f in res["frames"])
    assert f"wrote {n_frames} frames" in capsys.readouterr().out
    if with_cv2:
        import cv2

        assert res["written"]["output"] == os.path.join(out_dir, "output.mp4")
        cap = cv2.VideoCapture(res["written"]["output"])
        assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == n_frames
        cap.release()
    else:
        frame_dir = os.path.join(out_dir, "output.mp4.frames")
        assert res["written"]["output"] == frame_dir
        names = sorted(os.listdir(frame_dir))
        assert len(names) == n_frames
        for name, frame in zip(names, res["frames"]):
            np.testing.assert_array_equal(read_ppm(os.path.join(frame_dir, name)), frame)
        assert len(os.listdir(os.path.join(out_dir, "flow.mp4.frames"))) == 4


def test_wide_frames_without_ffmpeg_stay_ppm(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(video_nx.shutil, "which", lambda name: None)
    frames = [np.full((4, 2050, 3), i, np.uint8) for i in range(3)]
    path = str(tmp_path / "wide.mp4")
    assert video_nx.images_to_video(frames, path) == path + ".frames"
    assert sorted(os.listdir(path + ".frames")) == [f"{i:06d}.ppm" for i in range(3)]
    assert "saved as PPM" in capsys.readouterr().out


def test_reference_extras_load_strictly(ckpt, tmp_path):
    model = load_reference_state_dict(ckpt, GIMMVFI_R(raft_iters=2, device="cpu"))
    saved = torch.load(ckpt, weights_only=True)["state_dict"]
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, saved[f"module.{k}"], rtol=0, atol=0)
    # F: the dead Twins stage norms and GMA's position embedding too
    f_sd = init_normal_(GIMMVFI_F(ff_iters=2, device="cpu"), 1).state_dict()
    extras = {f"flow_estimator.{p}.svt.norm.{s}": torch.ones(4)
              for p in ("context_encoder", "memory_encoder.feat_encoder") for s in ("weight", "bias")}
    extras.update({f"flow_estimator.memory_decoder.att.pos_emb.rel_{a}.weight": torch.ones(3, 2)
                   for a in ("height", "width")})
    path = str(tmp_path / "f.pt")
    torch.save(reference_layout({**f_sd, **extras}), path)
    f_model = load_reference_state_dict(path, GIMMVFI_F(ff_iters=2, device="cpu"))
    torch.testing.assert_close(f_model.state_dict(), f_sd, rtol=0, atol=0)


def test_unknown_or_missing_key_raises(ckpt, tmp_path):
    sd = torch.load(ckpt, weights_only=True)["state_dict"]
    extra = str(tmp_path / "extra.pt")
    torch.save({**sd, "module.amt_fproj.extra_weight": torch.ones(1)}, extra)
    with pytest.raises(RuntimeError, match="amt_fproj.extra_weight"):
        load_reference_state_dict(extra, GIMMVFI_R(raft_iters=2, device="cpu"))
    missing = str(tmp_path / "missing.pt")
    torch.save({k: v for k, v in sd.items() if k != "module.alpha_v"}, missing)
    with pytest.raises(RuntimeError, match="alpha_v"):
        load_reference_state_dict(missing, GIMMVFI_R(raft_iters=2, device="cpu"))


def test_orbax_checkpoints_are_refused(tmp_path):
    with pytest.raises(ValueError, match="orbax"):
        video_nx.load_model(str(tmp_path / "orbax_dir"), device="cpu")


def test_flags_and_default_device():
    args = video_nx.parse_args(["--source-path", "s", "--output-path", "o", "--ckpt", "c.pt"])
    assert (args.N, args.ds_factor, args.fps, args.model, args.bucket, args.device) == (
        8, 1.0, 30, "gimmvfi_r", None, "cuda")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA card"):
            video_nx.main(["--source-path", "s", "--output-path", "o", "--ckpt", "c.pt"])
