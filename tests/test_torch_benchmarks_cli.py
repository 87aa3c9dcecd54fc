"""The port's benchmark harnesses (`gimmvfi_tpu_torch.cli.benchmarks`)
against the JAX harnesses, on fabricated fixtures, on the CPU.

Each pair of runs reads the same files and the same reference-layout `.pt`
(a random-init port model's state dict with the reference's wrappers and
extra keys): the JAX CLI converts it with `convert_*`, the port loads it
with `load_reference_state_dict`. Tolerances: PSNR 1e-3 dB, EPE 1e-4,
LPIPS 1e-4 inside a harness (its inputs are the two ports' predictions)
and 1e-5 on the same images.
  * `snu_film_arb` (medium split, one row of five 128x128 frames, R with 2
    RAFT iterations, with `--lpips-path`);
  * `vtf` and `vsf` on seeded `.flo` files at 64x64 with a GIMM `.pt`;
  * LPIPS port vs JAX with seeded random weights;
  * `_x4k_items` equal to JAX's on a fabricated tree; `x4k --split 4k` end
    to end through both CLIs on 33 linked 512x512 frames (7 items).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gimmvfi_tpu.cli import benchmarks as jax_benchmarks
from gimmvfi_tpu.train.lpips import LPIPS as JaxLPIPS
from gimmvfi_tpu.train.lpips import calc_lpips as jax_calc_lpips
from gimmvfi_tpu.utils.convert import convert_lpips
from gimmvfi_tpu_torch.cli import benchmarks
from gimmvfi_tpu_torch.data.frame_io import read_ppm, write_flo, write_ppm
from gimmvfi_tpu_torch.models.gimm import GIMM
from gimmvfi_tpu_torch.models.gimmvfi_r import GIMMVFI_R
from gimmvfi_tpu_torch.nn.layers import init_normal_
from gimmvfi_tpu_torch.train.lpips import LPIPS, calc_lpips
from gimmvfi_tpu_torch.utils.convert import jax_lpips_params_to_torch

torch.set_num_threads(1)


def _save_reference(sd: dict, path: str, extras: dict) -> str:
    torch.save({"state_dict": {f"module.{k}": v for k, v in {**sd, **extras}.items()}}, path)
    return path


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpts")
    vfi = init_normal_(GIMMVFI_R(raft_iters=2, device="cpu"), 21).state_dict()
    gimm = init_normal_(GIMM(device="cpu"), 22).state_dict()
    lpips = init_normal_(LPIPS(device="cpu"), 23).state_dict()
    g_filter = {"g_filter": torch.ones(1, 1, 3, 3) / 9}
    scaling = {"scaling_layer.shift": torch.tensor([-0.03, -0.088, -0.188]).view(1, 3, 1, 1),
               "scaling_layer.scale": torch.tensor([0.458, 0.448, 0.45]).view(1, 3, 1, 1)}
    return {"vfi": _save_reference(vfi, str(root / "vfi.pt"), g_filter),
            "gimm": _save_reference(gimm, str(root / "gimm.pt"), g_filter),
            "lpips": _save_reference(lpips, str(root / "lpips.pt"), scaling)}


def _run_both(capsys, argv):
    jax_benchmarks.main(argv)
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = benchmarks.main(argv + ["--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(got))
    return got, ref


def test_snu_film_arb_matches_jax(tmp_path, capsys, ckpts):
    root = str(tmp_path / "snu")
    rng = np.random.default_rng(0)
    base = (rng.random((136, 148, 3)) * 255).astype(np.uint8)
    row = []
    for k in range(5):  # i0, the 3 ground truths of the 4-step medium split, i1
        rel = f"frames/{k}.ppm"
        os.makedirs(os.path.join(root, "frames"), exist_ok=True)
        write_ppm(os.path.join(root, rel), np.ascontiguousarray(base[2 * k:2 * k + 128,
                                                                     5 * k:5 * k + 128]))
        row.append(rel)
    with open(os.path.join(root, "test-arb-medium.txt"), "w") as f:
        f.write(" ".join(row) + "\n")
    got, ref = _run_both(capsys, ["snu_film_arb", "--data-root", root, "--ckpt", ckpts["vfi"],
                                  "--flow-iters", "2", "--lpips-path", ckpts["lpips"]])
    assert sorted(got) == sorted(ref) == ["medium"]
    assert np.isfinite(got["medium"]["psnr"]) and np.isfinite(got["medium"]["lpips"])
    assert abs(got["medium"]["psnr"] - ref["medium"]["psnr"]) <= 1e-3
    assert abs(got["medium"]["lpips"] - ref["medium"]["lpips"]) <= 1e-4


def _flo_tree(root, names, seqs, rng, hw=(64, 64)):
    for s in seqs:
        d = os.path.join(root, "flow_sequences", s)
        os.makedirs(d, exist_ok=True)
        for name in names:
            write_flo(os.path.join(d, f"{name}.flo"),
                      (rng.random((*hw, 2)) * 4 - 2).astype(np.float32))


SEQS = ["00001/0001", "00001/0002"]


def test_vtf_matches_jax(tmp_path, capsys, ckpts):
    root = str(tmp_path / "vtf")
    _flo_tree(root, ("im1_im3", "im2_im3", "im2_im1", "im3_im1"), SEQS, np.random.default_rng(1))
    with open(os.path.join(root, "tri_testlist.txt"), "w") as f:
        f.write("\n".join(SEQS + ["00009/missing"]) + "\n")
    got, ref = _run_both(capsys, ["vtf", "--data-root", root, "--ckpt", ckpts["gimm"]])
    assert np.isfinite(got["psnr"]) and np.isfinite(got["epe"])
    assert abs(got["psnr"] - ref["psnr"]) <= 1e-3 and abs(got["epe"] - ref["epe"]) <= 1e-4


def test_vsf_matches_jax(tmp_path, capsys, ckpts):
    root = str(tmp_path / "vsf")
    names = (["im1_im7", "im7_im1"] + [f"im{t}_im7" for t in range(2, 7)]
             + [f"im{t}_im1" for t in range(2, 7)])
    _flo_tree(root, names, SEQS, np.random.default_rng(2))
    with open(os.path.join(root, "sep_testlist.txt"), "w") as f:
        f.write("\n".join(SEQS) + "\n")
    got, ref = _run_both(capsys, ["vsf", "--data-root", root, "--ckpt", ckpts["gimm"]])
    assert np.isfinite(got["psnr"]) and np.isfinite(got["epe"])
    assert abs(got["psnr"] - ref["psnr"]) <= 1e-3 and abs(got["epe"] - ref["epe"]) <= 1e-4


def test_lpips_matches_jax(ckpts):
    """Seeded random LPIPS weights through `convert_lpips` into JAX and
    back through `jax_lpips_params_to_torch`: <= 1e-5 on the same images,
    the harness's 8-bit quantized metric and the raw [-1, 1] one."""
    from gimmvfi_tpu.utils.convert import load_torch_state_dict

    params, _ = convert_lpips(load_torch_state_dict(ckpts["lpips"]))
    model = LPIPS(device="cpu")
    model.load_state_dict(jax_lpips_params_to_torch(params), strict=True)
    rng = np.random.default_rng(3)
    gt, pred = rng.random((2, 2, 72, 88, 3), dtype=np.float32)
    ref = np.asarray(jax.jit(lambda a, b: jax_calc_lpips(JaxLPIPS(), {"params": params}, a, b))(
        jnp.asarray(gt), jnp.asarray(pred)))
    got = calc_lpips(model, torch.from_numpy(gt), torch.from_numpy(pred)).numpy()
    assert got.shape == ref.shape == (2, 1, 1, 1)
    assert np.abs(got - ref).max() <= 1e-5
    raw_ref = np.asarray(JaxLPIPS().apply({"params": params}, jnp.asarray(2 * gt - 1),
                                          jnp.asarray(2 * pred - 1)))
    with torch.inference_mode():
        raw = model(torch.from_numpy(2 * gt - 1).permute(0, 3, 1, 2),
                    torch.from_numpy(2 * pred - 1).permute(0, 3, 1, 2)).numpy()
    assert np.abs(raw - raw_ref).max() <= 1e-5


def test_x4k_items_match_jax(tmp_path):
    root = tmp_path / "x4k"
    for typ, scenes in (("Type1", {"TEST01": 33, "TEST02": 70}), ("Type2", {"TEST03": 31})):
        for scene, n in scenes.items():
            d = root / typ / scene
            d.mkdir(parents=True)
            for i in range(n):
                (d / f"{i:04d}.png").write_bytes(b"")
    (root / "README.txt").write_text("not a type dir")
    got = benchmarks._x4k_items(str(root))
    assert got == jax_benchmarks._x4k_items(str(root))
    assert len(got) == 7 + 2 * 7  # 33 frames: one window of 32; 70: two; 31: none
    assert benchmarks._x4k_items(str(root), 4, 16) == jax_benchmarks._x4k_items(str(root), 4, 16)


def test_x4k_4k_split_end_to_end(tmp_path, capsys, ckpts):
    """Both X4K harnesses on 33 frames (3 distinct, the rest links) at
    512x512, DS 0.25: 7 items each, finite metrics, PSNR within 1e-3 dB of
    JAX's; the port's 7 predictions saved (PPM; the JAX CLI's are PNG)."""
    scene = tmp_path / "x4k" / "Type1" / "TEST01"
    scene.mkdir(parents=True)
    rng = np.random.default_rng(4)
    distinct = []
    for k in range(3):
        path = str(tmp_path / f"src{k}.ppm")
        write_ppm(path, (rng.random((512, 512, 3)) * 255).astype(np.uint8))
        distinct.append(path)
    for i in range(33):
        os.symlink(distinct[0 if i == 0 else 2 if i == 32 else 1], scene / f"{i:04d}.ppm")
    preds = str(tmp_path / "preds")
    argv = ["x4k", "--data-root", str(tmp_path / "x4k"), "--ckpt", ckpts["vfi"],
            "--flow-iters", "2", "--split", "4k", "--save-preds", preds]
    jax_benchmarks.main(argv)
    ref_out = capsys.readouterr().out
    ref = json.loads(ref_out.strip().splitlines()[-1])
    res = benchmarks.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert json.loads(out.strip().splitlines()[-1]) == json.loads(json.dumps(res))
    assert "over 7 frames" in out and "over 7 frames" in ref_out
    assert np.isfinite(res["psnr"]) and res["lpips"] is None and ref["lpips"] is None
    assert abs(res["psnr"] - ref["psnr"]) <= 1e-3
    names = sorted(n for n in os.listdir(preds) if n.endswith(".ppm"))
    assert names == [f"{i:05d}.ppm" for i in range(7)]
    assert read_ppm(os.path.join(preds, names[0])).shape == (512, 512, 3)


def test_flags_and_default_device():
    for name in benchmarks.RUNS:
        args = benchmarks.parse_args([name, "--data-root", "d", "--ckpt", "c.pt"])
        assert (args.ds_factor, args.model, args.device) == (1.0, "gimmvfi_r", "cuda")
    assert benchmarks.parse_args(["x4k", "--data-root", "d", "--ckpt", "c"]).split == "2k"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA card"):
            benchmarks.main(["vtf", "--data-root", "d", "--ckpt", "c.pt"])
