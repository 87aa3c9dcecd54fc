"""Evaluation benchmark harnesses on one CUDA card: SNU-FILM-arb, X4K, VTF
and VSF (`gimmvfi_tpu/cli/benchmarks.py`), as one CLI.

Each harness loads a reference `.pt`/`.pth` checkpoint, walks its dataset
and prints one JSON line last: PSNR, and LPIPS when `--lpips-path` gives a
reference LPIPS checkpoint, for the frame benchmarks; flow PSNR and EPE for
the stage-1 motion benchmarks (VTF, VSF), which run GIMM.

    python -m gimmvfi_tpu_torch.cli.benchmarks snu_film_arb --data-root ... --ckpt ...
    python -m gimmvfi_tpu_torch.cli.benchmarks x4k --data-root ... --ckpt ... --split 2k
    python -m gimmvfi_tpu_torch.cli.benchmarks vtf --data-root ... --ckpt gimm.pt
    python -m gimmvfi_tpu_torch.cli.benchmarks vsf --data-root ... --ckpt gimm.pt

Models compute in float32 with TF32 off. The card is the default device;
`--device cpu` is for the CPU tests.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch
import torch.nn.functional as F

from ..data.frame_io import read_flo, read_image, write_ppm
from ..models.gimm import GIMM
from ..ops.coords import sample_coords_3d
from ..ops.pad import InputPadder
from ..utils.convert import load_reference_state_dict
from ..utils.metrics import compute_psnr_np
from .video_nx import interpolate_padded, load_model

X4K_2K_SIZE = (1080, 2048)  # (H, W) of the 2k split


def _lpips_fn(lpips_path: str | None, device):
    """The LPIPS metric of one (H, W, 3) pair in [0, 1], or None without
    weights."""
    if not lpips_path:
        return None
    from ..train.lpips import LPIPS, calc_lpips

    model = load_reference_state_dict(lpips_path, LPIPS(device=device)).eval()
    return lambda gt, pred: float(calc_lpips(model, gt[None], pred[None]).reshape(()))


def _mean(values):
    return float(np.mean(values)) if values else None


# --------------------------------------------------------------- SNU-FILM-arb
def run_snu_film_arb(args) -> dict:
    """Splits medium/hard/extreme: 4/8/16-step arbitrary-t interpolation, one
    pair emitting every t_i = (i + 1) / T. PSNR and LPIPS."""
    model = load_model(args.ckpt, args.model, args.flow_iters, args.device)
    lp = _lpips_fn(args.lpips_path, args.device)
    results = {}
    for split, t_step in (("medium", 4), ("hard", 8), ("extreme", 16)):
        list_path = os.path.join(args.data_root, f"test-arb-{split}.txt")
        if not os.path.exists(list_path):
            print(f"skip {split}: {list_path} missing")
            continue
        with open(list_path) as f:
            rows = [ln.split() for ln in f.read().splitlines() if ln.strip()]
        psnrs, lpips_vals = [], []
        for row in rows:
            frames = [read_image(os.path.join(args.data_root, p)) for p in row]
            i0, gts, i1 = frames[0], frames[1:-1], frames[-1]
            padder = InputPadder(i0.shape[:2], 32, bucket=args.bucket)
            ts = [(i + 1) / t_step for i in range(t_step - 1)]
            preds, _ = interpolate_padded(model, padder, i0, i1, ts, args.ds_factor)
            for gt, pred in zip(gts, preds):
                psnrs.append(compute_psnr_np(pred, gt))
                if lp is not None:
                    lpips_vals.append(lp(gt, pred))
        results[split] = {"psnr": _mean(psnrs), "lpips": _mean(lpips_vals)}
        print(f"SNU-FILM-arb {split}: {results[split]}")
    return results


# ------------------------------------------------------------------------ X4K
def _x4k_items(test_root: str, multiple: int = 8, t_step: int = 32):
    """XVFI-style enumeration: (frame 0, frame 1, ground truth, t) items."""
    items = []
    for typ in sorted(os.listdir(test_root)):
        type_dir = os.path.join(test_root, typ)
        if not os.path.isdir(type_dir):
            continue
        for scene in sorted(os.listdir(type_dir)):
            frames = sorted(
                os.path.join(type_dir, scene, f)
                for f in os.listdir(os.path.join(type_dir, scene))
            )
            for idx in range(0, len(frames) - t_step, t_step):
                for mul in range(multiple - 1):
                    t = (mul + 1) / multiple
                    items.append((frames[idx], frames[idx + t_step],
                                  frames[idx + int(round(t_step * t))], t))
    return items


def area_downscale(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """(H, W, C) float32 -> `size` (h, w) by averaging H/h x W/w blocks, the
    same as cv2's INTER_AREA at an integer factor (the X4K 2k split's
    4096x2160 -> 2048x1080 is an exact 2x). Other factors raise."""
    (h0, w0), (h, w) = img.shape[:2], size
    if h0 % h or w0 % w or h0 // h != w0 // w:
        raise ValueError(f"area downscale takes one integer factor, got {w0}x{h0} -> {w}x{h}")
    k = h0 // h
    x = torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)[None]
    return F.avg_pool2d(x, k).permute(0, 2, 3, 1)[0].numpy()


def run_x4k(args) -> dict:
    """XTEST 8x interpolation: 2k (frames averaged down to 2048x1080, DS 0.5)
    or 4k (DS 0.25). PSNR and LPIPS; `--save-preds` writes each prediction
    as a binary PPM."""
    model = load_model(args.ckpt, args.model, args.flow_iters, args.device)
    lp = _lpips_fn(args.lpips_path, args.device)
    ds = 0.5 if args.split == "2k" else 0.25
    if args.save_preds:
        os.makedirs(args.save_preds, exist_ok=True)

    psnrs, lpips_vals = [], []
    for idx, (p0, p1, pt, t) in enumerate(_x4k_items(args.data_root)):
        i0, i1, gt = (read_image(p) for p in (p0, p1, pt))
        if args.split == "2k":
            i0, i1, gt = (area_downscale(x, X4K_2K_SIZE) for x in (i0, i1, gt))
        padder = InputPadder(i0.shape[:2], 32, bucket=args.bucket)
        pred = interpolate_padded(model, padder, i0, i1, [float(t)], ds)[0][0]
        psnrs.append(compute_psnr_np(pred, gt))
        if lp is not None:
            lpips_vals.append(lp(gt, pred))
        if args.save_preds:
            write_ppm(os.path.join(args.save_preds, f"{idx:05d}.ppm"),
                      (np.clip(pred, 0, 1) * 255).astype(np.uint8))
    res = {"psnr": _mean(psnrs), "lpips": _mean(lpips_vals)}
    print(f"X4K {args.split}: {res} over {len(psnrs)} frames")
    return res


# ------------------------------------------------------------------- VTF/VSF
def _load_gimm(args) -> GIMM:
    return load_reference_state_dict(args.ckpt, GIMM(device=args.device)).eval()


def _flow_scores(pred: np.ndarray, target: np.ndarray, flow: np.ndarray, scaler) -> tuple:
    """(PSNR of the normalized flow, EPE of the flow)."""
    pred_flow = (pred * 2 - 1) * scaler
    return compute_psnr_np(pred, target), float(np.linalg.norm(pred_flow - flow, axis=-1).mean())


@torch.inference_mode()
def run_vtf(args) -> dict:
    """Stage-1 motion benchmark on Vimeo-Triplet-Flow: flow PSNR (normalized)
    and EPE at t = 0.5."""
    model = _load_gimm(args)
    with open(os.path.join(args.data_root, "tri_testlist.txt")) as f:
        seqs = [x for x in f.read().splitlines() if x.strip()]

    psnrs, epes = [], []
    for seq in seqs:
        d = os.path.join(args.data_root, "flow_sequences", seq)
        if not os.path.isdir(d):
            continue
        f01 = read_flo(os.path.join(d, "im1_im3.flo"))
        fmid = read_flo(os.path.join(d, "im2_im3.flo")) - read_flo(os.path.join(d, "im2_im1.flo"))
        f10 = -read_flo(os.path.join(d, "im3_im1.flo"))
        scaler = max(np.abs(f01).max(), np.abs(f10).max())

        def nf(f):
            return (f / scaler + 1.0) / 2.0

        xs = torch.from_numpy(np.stack([nf(f01), nf(f10)])[None].astype(np.float32))
        ori = torch.from_numpy(np.stack([f01, -f10])[None].astype(np.float32))
        pred = model(xs, ori, torch.tensor([0.5])).cpu().numpy()[0, 0]
        psnr, epe = _flow_scores(pred, nf(fmid), fmid, scaler)
        psnrs.append(psnr)
        epes.append(epe)
    print(f"VTF: flow PSNR {np.mean(psnrs):.3f}, EPE {np.mean(epes):.3f}")
    return {"psnr": float(np.mean(psnrs)), "epe": float(np.mean(epes))}


@torch.inference_mode()
def run_vsf(args) -> dict:
    """Stage-1 motion benchmark on Vimeo-Septuplet-Flow: flow PSNR
    (normalized) and EPE at frames t_id = 2..6.

    As the reference does, the INR coordinate's time is (t_id - 1) / 6
    while the splat's timestep is t_id / 6; the coordinate goes to `GIMM`
    as given."""
    model = _load_gimm(args)
    dev = model.alpha_v.device
    with open(os.path.join(args.data_root, "sep_testlist.txt")) as f:
        seqs = [x for x in f.read().splitlines() if x.strip()]

    psnrs, epes = [], []
    for seq in seqs:
        d = os.path.join(args.data_root, "flow_sequences", seq)
        if not os.path.isdir(d):
            continue
        f01 = read_flo(os.path.join(d, "im1_im7.flo"))
        f10 = read_flo(os.path.join(d, "im7_im1.flo"))
        h, w = f01.shape[:2]
        for t_id in range(2, 7):
            gt = (read_flo(os.path.join(d, f"im{t_id}_im7.flo"))
                  - read_flo(os.path.join(d, f"im{t_id}_im1.flo")))
            xs_raw = np.stack([f01, -f10])[None]  # (1, 2, H, W, 2)
            scaler = float(np.abs(xs_raw).max())

            def nf(f):
                return (f / scaler + 1.0) / 2.0

            xs = torch.from_numpy(nf(xs_raw).astype(np.float32))
            ori = torch.from_numpy(np.stack([f01, f10])[None].astype(np.float32))
            coord = sample_coords_3d(1, (h, w), [(t_id - 1) / 6.0], dev)
            pred = model(xs, ori, torch.tensor([t_id / 6.0]), coord=coord).cpu().numpy()[0, 0]
            psnr, epe = _flow_scores(pred, nf(gt), gt, scaler)
            psnrs.append(psnr)
            epes.append(epe)
    print(f"VSF: flow PSNR {np.mean(psnrs):.3f}, EPE {np.mean(epes):.3f}")
    return {"psnr": float(np.mean(psnrs)), "epe": float(np.mean(epes))}


RUNS = {"snu_film_arb": run_snu_film_arb, "x4k": run_x4k, "vtf": run_vtf, "vsf": run_vsf}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m gimmvfi_tpu_torch.cli.benchmarks",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="bench", required=True)
    for name in RUNS:
        sp = sub.add_parser(name)
        sp.add_argument("--data-root", required=True)
        sp.add_argument("--ckpt", required=True, help="reference .pt/.pth checkpoint")
        sp.add_argument("--ds-factor", type=float, default=1.0)
        sp.add_argument("--lpips-path", default=None, help="reference LPIPS .pt/.pth")
        sp.add_argument("--model", default="gimmvfi_r", choices=["gimmvfi_r", "gimmvfi_f"])
        sp.add_argument("--flow-iters", type=int, default=None)
        sp.add_argument("--bucket", type=int, default=None,
                        help="round padded sizes up to a multiple of this (e.g. 128)")
        sp.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="cuda (default); cpu only for the CPU tests")
        if name == "x4k":
            sp.add_argument("--split", choices=("2k", "4k"), default="2k")
            sp.add_argument("--save-preds", default=None,
                            help="directory for the predictions, as binary PPM")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run one harness; returns the result its last line prints."""
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the harnesses run on a CUDA card (--device cpu is for the CPU tests)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    res = RUNS[args.bench](args)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
