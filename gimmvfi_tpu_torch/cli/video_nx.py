"""Nx video interpolation on one CUDA card (`gimmvfi_tpu/cli/video_nx.py`).

Reads a directory of frames, interpolates N-1 arbitrary timesteps between
each adjacent pair with GIMM-VFI (R or F, float32, full width), and writes
an output video (original || interpolated, side by side) and a
flow-visualization video.

    python -m gimmvfi_tpu_torch.cli.video_nx --source-path demo/input_frames \\
        --output-path out --N 8 --ds-factor 1.0 --ckpt gimmvfi_r_arb_lpips.pt

`--ckpt` is a reference `.pt`/`.pth` checkpoint. PPM frames are read with
numpy alone; PNG/JPEG need Pillow. Videos are written with cv2 up to 2048
px a side and with ffmpeg above (from PPM frames); with neither at hand the
frames stay as binary PPM in `<video path>.frames/`. The card is the
default device and TF32 is off, so float32 means float32; `--device cpu`
is for the CPU tests.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import time

import numpy as np
import torch

from ..data.frame_io import read_image, write_ppm
from ..models.gimmvfi_r import GIMMVFI_R, interpolate_sequential
from ..ops.pad import InputPadder
from ..utils.convert import load_reference_state_dict
from ..utils.flow_viz import flow_to_image


def images_to_video(frames: list[np.ndarray], path: str, fps: int = 30) -> str:
    """Write RGB uint8 frames as a video at `path`: cv2's mp4v writer up to
    2048 px a side (its encoder rejects larger frames), ffmpeg above. When
    the one that applies is missing, the frames stay as binary PPM in
    `<path>.frames/`. Returns what was written."""
    h, w = frames[0].shape[:2]
    if max(h, w) <= 2048:
        try:
            import cv2
        except ImportError:
            cv2 = None
        if cv2 is not None:
            writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
            for f in frames:
                writer.write(np.ascontiguousarray(f[:, :, ::-1]))
            writer.release()
            return path
    frame_dir = path + ".frames"
    os.makedirs(frame_dir, exist_ok=True)
    for i, f in enumerate(frames):
        write_ppm(os.path.join(frame_dir, f"{i:06d}.ppm"), f)
    if max(h, w) > 2048 and shutil.which("ffmpeg"):
        cmd = ["ffmpeg", "-y", "-framerate", str(fps), "-i", os.path.join(frame_dir, "%06d.ppm"),
               "-c:v", "libx264", "-pix_fmt", "yuv420p", path]
        subprocess.run(cmd, check=True, capture_output=True)
        shutil.rmtree(frame_dir)
        return path
    print(f"no video encoder for {w}x{h} frames; {len(frames)} frames saved as PPM to {frame_dir}")
    return frame_dir


def load_model(ckpt_path: str, model_type: str = "gimmvfi_r", flow_iters: int | None = None,
               device=None) -> GIMMVFI_R:
    """GIMM-VFI-R (`raft_iters` 20) or -F (`ff_iters` 32) at full width,
    float32, without remat (inference, as JAX's CLI builds it), on
    `device` (the card when None), with a reference
    `.pt`/`.pth` checkpoint loaded strictly. The port reads no orbax
    checkpoint: that is the JAX package's own format."""
    if not ckpt_path.endswith((".pt", ".pth")):
        raise ValueError(f"{ckpt_path}: the port loads reference .pt/.pth checkpoints only "
                         "(orbax checkpoints are the JAX package's format)")
    if model_type == "gimmvfi_f":
        from ..models.gimmvfi_f import GIMMVFI_F

        model = GIMMVFI_F(ff_iters=flow_iters or 32, device=device, remat=False)
    else:
        model = GIMMVFI_R(raft_iters=flow_iters or 20, device=device, remat=False)
    return load_reference_state_dict(ckpt_path, model).eval()


def interpolate_padded(model: GIMMVFI_R, padder: InputPadder, img0: np.ndarray,
                       img1: np.ndarray, ts, ds_factor: float | None):
    """Two (H, W, 3) float32 frames padded by `padder` on the model's
    device, one `interpolate_sequential` at `ts` (DS_SCALE when
    `ds_factor` is not None or 1), unpadded. Returns (frames (T, H, W, 3),
    flows (T, h, w, 2)) as numpy arrays; under DS_SCALE the flows are at
    the working size, cut by the same padder, as in the JAX CLI."""
    pair = torch.from_numpy(np.stack([img0, img1])).to(model.alpha_v.device).permute(0, 3, 1, 2)
    xs = padder.pad(pair).permute(0, 2, 3, 1)[None]  # (1, 2, H', W', 3)
    out = interpolate_sequential(model, xs, ts, None if ds_factor in (None, 1.0) else ds_factor)
    frames = padder.unpad(out["imgt_pred"][:, 0].permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    flows = padder.unpad(out["flowt"][:, 0].permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    return frames.cpu().numpy(), flows.cpu().numpy()


def interpolate_pair(model: GIMMVFI_R, img0: np.ndarray, img1: np.ndarray, n: int,
                     ds_factor: float | None, bucket: int | None = None):
    """N-1 timesteps t = i/N between two (H, W, 3) float32 frames, padded
    to a multiple of 32 (or of `bucket`). Returns (frames, flows): lists
    of (H, W, 3) and (H, W, 2) numpy arrays."""
    padder = InputPadder(img0.shape[:2], divisor=32, bucket=bucket)
    frames, flows = interpolate_padded(model, padder, img0, img1, [i / n for i in range(1, n)],
                                       ds_factor)
    return list(frames), list(flows)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m gimmvfi_tpu_torch.cli.video_nx",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--source-path", required=True, help="directory of frames, read in name order")
    p.add_argument("--output-path", required=True)
    p.add_argument("--N", type=int, default=8, help="interpolation factor: N-1 frames a pair")
    p.add_argument("--ds-factor", type=float, default=1.0,
                   help="DS_SCALE working-resolution factor (0.5 for 2K, 0.25 for 4K)")
    p.add_argument("--ckpt", required=True,
                   help="reference .pt/.pth checkpoint (orbax checkpoints are not read)")
    p.add_argument("--fps", type=int, default=30)
    p.add_argument("--model", default="gimmvfi_r", choices=["gimmvfi_r", "gimmvfi_f"])
    p.add_argument("--bucket", type=int, default=None,
                   help="pad to multiples of this (>= 32), so that mixed frame sizes share "
                        "padded sizes")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (default); cpu only for the CPU tests")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the CLI. Returns the frames and flow images written (RGB uint8),
    what was written for each video, and each pair's ms (host clock around
    `interpolate_pair`, which ends in a copy to the host)."""
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the video CLI runs on a CUDA card (--device cpu is for the CPU tests)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    os.makedirs(args.output_path, exist_ok=True)
    model = load_model(args.ckpt, args.model, device=args.device)

    img_list = sorted(os.listdir(args.source_path))
    images, flows_viz, pair_ms = [], [], []
    first = read_image(os.path.join(args.source_path, img_list[0]))
    first_u8 = (first * 255).astype(np.uint8)
    images.append(np.concatenate([first_u8, first_u8], axis=1))

    for j in range(len(img_list) - 1):
        i0 = read_image(os.path.join(args.source_path, img_list[j]))
        i1 = read_image(os.path.join(args.source_path, img_list[j + 1]))
        t0 = time.perf_counter()
        frames, flows = interpolate_pair(model, i0, i1, args.N, args.ds_factor, args.bucket)
        pair_ms.append((time.perf_counter() - t0) * 1e3)
        hold = (i1 * 255).astype(np.uint8)
        for f, fl in zip(frames, flows):
            pred = (np.clip(f, 0, 1) * 255).astype(np.uint8)
            images.append(np.concatenate([hold, pred], axis=1))
            flows_viz.append(flow_to_image(fl))
        images.append(np.concatenate([hold, hold], axis=1))

    written = {"output": images_to_video(images, os.path.join(args.output_path, "output.mp4"),
                                         args.fps)}
    if flows_viz:
        written["flow"] = images_to_video(flows_viz, os.path.join(args.output_path, "flow.mp4"),
                                          args.fps)
    print(f"wrote {len(images)} frames to {args.output_path}; ms a pair: "
          f"{', '.join(f'{ms:.2f}' for ms in pair_ms)}")
    return {"frames": images, "flows": flows_viz, "written": written, "pair_ms": pair_ms}


if __name__ == "__main__":
    main()
