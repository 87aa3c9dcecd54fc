"""The port imports neither JAX nor the JAX package.

In a subprocess where `jax`, `flax` and `gimmvfi_tpu` cannot be imported,
every module of `gimmvfi_tpu_torch` (the CLIs, the tools and the bench
included) and `chip_smoke.py` import, and none of the three is loaded.
"""

import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]

_CHECK = r"""
import importlib.abc, pathlib, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "flax", "gimmvfi_tpu")


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None


sys.meta_path.insert(0, Block())
root = pathlib.Path(sys.argv[1])
names = ["gimmvfi_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages([str(root / "gimmvfi_tpu_torch")],
                                          prefix="gimmvfi_tpu_torch.")]
for name in sorted(names):
    __import__(name)
import chip_smoke  # noqa: F401
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not loaded, loaded
print("OK", len(names), " ".join(sorted(names)))
"""


def test_port_imports_no_jax():
    proc = subprocess.run([sys.executable, "-c", _CHECK, str(REPO)], capture_output=True,
                          text=True, cwd=str(REPO), timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("OK"), proc.stdout
    imported = proc.stdout.split()[2:]
    for name in ("cli.video_nx", "cli.benchmarks", "models.gimm", "ops.pad", "data.frame_io",
                 "utils.metrics", "utils.flow_viz", "train.lpips", "tools.raft_f32_profile",
                 "cli.train", "train.optim", "train.ema", "train.train_state", "train.checkpoint",
                 "utils.config", "utils.writer", "data.loader", "data.flow_dataset"):
        assert f"gimmvfi_tpu_torch.{name}" in imported
