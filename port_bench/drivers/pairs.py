"""The video entry's per-pair path, closed loop on one stream.

Call k sends pair k of a seeded clip, cycled (frames k mod P and k mod P +
1, P = frames - 1 pairs), through the program's
`gimmvfi_tpu_torch.cli.video_nx.interpolate_padded`: the frames go to the
card, are edge-padded to a multiple of 32, interpolated at the call's
timesteps (DS_SCALE at the mix's `ds`), unpadded, and come back to the
host with their flows. The mix's `timesteps` is "all" (t = 1/n ... (n-1)/n
each call, Nx video) or "one" (call k takes t = (k mod (n-1) + 1) / n, one
model call a timestep as the X4K protocol makes them).

The program is built as the video CLI builds it (`configs/<name>.json`'s
`program`: the class, its options and the compute dtype), with the
benchmark's seeded weights loaded strictly. `control` puts the reference in
its place at the control's lower precision (`controlled_precision`).
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

from ..clip import make_clip
from ..reference.gimmvfi import DTYPES, GIMMVFI, Precision
from ..reference.gimmvfi import interpolate_padded as reference_interpolate
from ..reference.ops import quantize_convs_fp8
from ..weights import make_weights, state_shapes


def build_reference(config: dict, precision: Precision, device) -> GIMMVFI:
    ref = config["reference"]
    with torch.device(device):
        return GIMMVFI(ref["flow"], ref["iters"], precision,
                       stated=Precision.named(config["precision"]),
                       max_volume_bytes=config["corr_max_volume_bytes"]).eval().requires_grad_(False)


def controlled_precision(config: dict) -> Precision:
    """Each stated precision one step lower: float32 parts in bf16 (the
    bf16 parts' step, float8, is `quantize_convs_fp8`)."""
    stated = Precision.named(config["precision"])
    lower = {None: torch.bfloat16, torch.bfloat16: torch.bfloat16}
    return Precision(compute=stated.compute, hyponet=lower[stated.hyponet], flow=lower[stated.flow])


class PairsDriver:
    def __init__(self, cell, seed: int, device, control: bool = False):
        self.cell, self.seed, self.device, self.control = cell, seed, torch.device(device), control
        t = cell.traffic
        self.ds = t["ds"]
        n = t["n"]
        self.all_ts = [i / n for i in range(1, n)]
        self.model = None
        self.clip = None
        self._interpolate = None

    # ------------------------------------------------------------ inputs
    def weight_shapes(self) -> dict:
        stated = Precision.named(self.cell.config["precision"])
        return state_shapes(build_reference(self.cell.config, stated, "meta"))

    def weights(self) -> dict:
        return make_weights(self.weight_shapes(), self.seed, self.device)

    def timesteps(self, k: int) -> list[float]:
        if self.cell.traffic["timesteps"] == "all":
            return self.all_ts
        return [self.all_ts[k % len(self.all_ts)]]

    def pair(self, k: int) -> tuple[np.ndarray, np.ndarray]:
        j = k % (len(self.clip) - 1)
        return self.clip[j], self.clip[j + 1]

    # ------------------------------------------------------------- set-up
    def build(self):
        """The system under test on the device: the program as the video
        CLI builds it, or under `control` the reference at the lower
        precision."""
        cfg = self.cell.config
        if self.control:
            self.model = build_reference(cfg, controlled_precision(cfg), self.device)
            quantize_convs_fp8(self.model)
            self._interpolate = reference_interpolate
            return
        prog = cfg["program"]
        cls = getattr(importlib.import_module(prog["module"]), prog["class"])
        self.model = cls(**prog["kwargs"], dtype=DTYPES[cfg["precision"]["compute"]],
                         device=self.device).eval()
        entry = importlib.import_module("gimmvfi_tpu_torch.cli.video_nx")
        padder = importlib.import_module("gimmvfi_tpu_torch.ops.pad").InputPadder
        h, w = self.cell.traffic["height"], self.cell.traffic["width"]
        pad = padder((h, w), divisor=32)

        def run(model, img0, img1, ts, ds):
            return entry.interpolate_padded(model, pad, img0, img1, ts, ds)

        self._interpolate = run

    def setup(self):
        """Build, load the seeded weights, make the clip, warm up the
        mix's shapes (`warmup_calls` calls, pairs not in the window's
        first calls' order)."""
        self.build()
        self.model.load_state_dict(self.weights(), strict=True)
        t = self.cell.traffic
        self.clip = make_clip(self.seed, t["clip_frames"], t["height"], t["width"],
                              t["max_shift_px"], t["octaves"], self.device)
        for k in range(t["warmup_calls"]):
            self.call(len(self.clip) - 2 - k)

    def reseed(self, seed: int):
        """New weights and clip from `seed` into the built model (the
        calibration's loop over seeds in one process)."""
        self.seed = seed
        self.model.load_state_dict(self.weights(), strict=True)
        t = self.cell.traffic
        self.clip = make_clip(seed, t["clip_frames"], t["height"], t["width"],
                              t["max_shift_px"], t["octaves"], self.device)

    # -------------------------------------------------------------- window
    def call(self, k: int) -> dict:
        """Call k: its frames and flows on the host."""
        img0, img1 = self.pair(k)
        frames, flows = self._interpolate(self.model, img0, img1, self.timesteps(k), self.ds)
        return {"frames": frames, "flows": flows}

    @staticmethod
    def produced(out: dict) -> int:
        return len(out["frames"])

    def release(self):
        self.model = None
        self._interpolate = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ----------------------------------------------------------- reference
    def reference(self, stated: bool = False) -> GIMMVFI:
        """The reference on the device with this seed's weights: float32,
        or with `stated` at the configuration's stated precision (the
        yardstick of `compare`)."""
        cfg = self.cell.config
        prec = Precision.named(cfg["precision"]) if stated else Precision(None, None, None)
        ref = build_reference(cfg, prec, self.device)
        ref.load_state_dict(self.weights(), strict=True)
        return ref

    def expected(self, ref: GIMMVFI, k: int) -> dict:
        img0, img1 = self.pair(k)
        frames, flows = reference_interpolate(ref, img0, img1, self.timesteps(k), self.ds)
        return {"frames": frames, "flows": flows}


def rms(a, b) -> float:
    """RMS of a - b in float64; NaN where a shape differs or a value of `a`
    is not finite."""
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    if a.shape != b.shape or not np.isfinite(a).all():
        return float("nan")
    return float(np.sqrt(np.mean((a - b) ** 2)))


def compare(out: dict, exp: dict, base: dict) -> dict:
    """The numbers compared for one call, against the float32 reference's
    outputs `exp`: the RMS error of the call's frames (values in [0, 1])
    and of its flows (pixels) over the RMS error that the reference itself
    makes at the configuration's stated precision (`base`, the yardstick:
    how far rounding at that precision moves this seed's outputs). The
    absolute errors ride along: `frame_rmse`, and `flow_rel_rmse` over the
    reference flows' RMS. NaN wherever a shape differs or a value is not
    finite."""
    f, y = rms(out["frames"], exp["frames"]), rms(base["frames"], exp["frames"])
    g, z = rms(out["flows"], exp["flows"]), rms(base["flows"], exp["flows"])
    r = rms(exp["flows"], np.zeros_like(exp["flows"]))
    return {"frame_err_ratio": f / max(y, 1e-12), "flow_err_ratio": g / max(z, 1e-12),
            "frame_rmse": f, "flow_rel_rmse": g / max(r, 1e-12)}


Driver = PairsDriver
