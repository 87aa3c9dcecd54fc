"""GIMM-VFI-R's float32 `prepare` on the card with RAFT's motion-encoder
convs as GEMMs (as built) and through cuDNN, in turns.

    python -m gimmvfi_tpu_torch.tools.raft_f32_profile [--size 736x1280]

Card only: without CUDA `main` raises. GIMMVFI_R(raft_iters=20) float32,
random weights (`init_normal_`, seed 0), a seeded random pair of `--size`
(HxW), TF32 off. In float32 RAFT's `update_block.encoder.convc2` and
`.conv` (3x3 over 256 channels) are `GemmConv2d`; the "cuDNN" variant puts
`Conv2d`s with the same weights in their place. `prepare` and RAFT alone,
by CUDA events, in the turns GEMM, cuDNN, cuDNN, GEMM (one warm-up call
before each variant's first turn); then `prepare` of the same model in
bf16 (which keeps cuDNN) beside them; then the two convs alone at the 1/8
grid (`flowformer_profile.motion_conv_ms`).
"""

from __future__ import annotations

import argparse
import statistics

import torch

from ..models.gimmvfi_r import GIMMVFI_R
from ..nn.layers import Conv2d, init_normal_
from ..utils.timing import cuda_ms
from .flowformer_profile import motion_conv_ms

WIDE_CONVS = ("convc2", "conv")


def swap_wide_convs(model: GIMMVFI_R, cls) -> None:
    """Put `cls` convs with the same weights in place of RAFT's wide
    motion-encoder convs."""
    enc = model.flow_estimator.update_block.encoder
    for name in WIDE_CONVS:
        old = getattr(enc, name)
        new = cls(old.in_channels, old.out_channels, 3, 1, 1, compute_dtype=old.compute_dtype)
        new.load_state_dict(old.state_dict())
        setattr(enc, name, new.to(old.weight.device))


@torch.inference_mode()
def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="python -m gimmvfi_tpu_torch.tools.raft_f32_profile")
    p.add_argument("--size", default="736x1280", help="HxW")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this profile needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    h, w = (int(s) for s in args.size.split("x"))
    model = init_normal_(GIMMVFI_R(raft_iters=20), 0).eval()
    gemm_cls = type(model.flow_estimator.update_block.encoder.convc2)
    gen = torch.Generator(device="cpu").manual_seed(1)
    img_xs = torch.rand((1, 2, h, w, 3), generator=gen).cuda()
    img0 = 255.0 * img_xs[:, 0].permute(0, 3, 1, 2)
    img1 = 255.0 * img_xs[:, 1].permute(0, 3, 1, 2)

    times = {"gemm": {"prepare": [], "raft": []}, "cudnn": {"prepare": [], "raft": []}}
    warm = set()
    for variant in ("gemm", "cudnn", "cudnn", "gemm"):
        swap_wide_convs(model, gemm_cls if variant == "gemm" else Conv2d)
        warmup = 0 if variant in warm else 1
        warm.add(variant)
        times[variant]["prepare"].append(
            cuda_ms(lambda: model.prepare(img_xs), iters=1, warmup=warmup))
        times[variant]["raft"].append(cuda_ms(lambda: model.bidir_flow(img0, img1), iters=1,
                                              warmup=0))
        print(f"R float32 {h}x{w}, RAFT motion-encoder convs through {variant}: prepare "
              f"{times[variant]['prepare'][-1]:.2f} ms, RAFT alone {times[variant]['raft'][-1]:.2f} "
              f"ms", flush=True)
    out = {v: {k: statistics.mean(t) for k, t in d.items()} for v, d in times.items()}
    del model
    torch.cuda.empty_cache()

    bf16 = init_normal_(GIMMVFI_R(raft_iters=20, dtype=torch.bfloat16), 0).eval()
    out["bf16"] = {"prepare": cuda_ms(lambda: bf16.prepare(img_xs), iters=3),
                   "raft": cuda_ms(lambda: bf16.bidir_flow(img0, img1), iters=3)}
    print(f"R bf16 {h}x{w} (cuDNN): prepare {out['bf16']['prepare']:.2f} ms, RAFT alone "
          f"{out['bf16']['raft']:.2f} ms (median of 3)", flush=True)
    del bf16
    torch.cuda.empty_cache()
    out["motion_convs"] = motion_conv_ms(h, w)
    return out


if __name__ == "__main__":
    main()
