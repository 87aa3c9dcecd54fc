"""The port's stage-2 data (`data/vimeo_arb.py`) against the JAX package's, on the CPU.

A fabricated tree in the recipe's layout: `<tmp>/vimeo_septuplet` with
`all_sep.txt` and `<tmp>/vimeo_triplet` with `tri_testlist.txt` (the test
split's redirect; its last line is dropped, as the reference's), 144x176
PNGs written with Pillow. For the same seeds the train items (with and
without augmentation, over enough draws to take every branch), the test
items and the loader's batches (the scalar `t` stacked) equal JAX's
`VimeoArbitrary` and `DataLoader`'s bit for bit. PNGs read through cv2 when
Pillow is missing give the same pixels.
"""

import sys

import numpy as np
import pytest
from PIL import Image

from gimmvfi_tpu.data.loader import DataLoader as JaxDataLoader
from gimmvfi_tpu.data.vimeo_arb import VimeoArbitrary as JaxVimeoArbitrary
from gimmvfi_tpu_torch.data import DataLoader, VimeoArbitrary, create_dataset
from gimmvfi_tpu_torch.data.frame_io import read_image

HW = (144, 176)
CROP = (128, 128)
SEQS = [f"00001/{i:04d}" for i in range(6)]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("vimeo")
    rng = np.random.default_rng(0)
    for split, frames, listing, extra in (("vimeo_septuplet", 7, "all_sep.txt", []),
                                          ("vimeo_triplet", 3, "tri_testlist.txt", ["dummy_last"])):
        for s in SEQS:
            d = root / split / "sequences" / s
            d.mkdir(parents=True)
            for k in range(1, frames + 1):
                img = (rng.random((*HW, 3)) * 255).astype(np.uint8)
                Image.fromarray(img).save(d / f"im{k}.png")
        (root / split / listing).write_text("\n".join(SEQS + extra) + "\n")
    return str(root / "vimeo_septuplet")


def _same(a: dict, b: dict):
    assert sorted(a) == sorted(b) == ["gt", "img0", "img1", "t"]
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y), k


@pytest.mark.parametrize("split,aug", [("train", True), ("train", False), ("test", True)])
def test_items_equal_jax(tree, split, aug):
    ours = VimeoArbitrary(tree, split=split, aug=aug, crop_size=CROP)
    ref = JaxVimeoArbitrary(tree, split=split, aug=aug, crop_size=CROP)
    assert ours.meta_data == ref.meta_data == SEQS and ours.image_root == ref.image_root
    shapes = set()
    for seed in range(40):
        i = seed % len(ours)
        a = ours[i, np.random.default_rng(seed)]
        b = ref[i, np.random.default_rng(seed)]
        _same(a, b)
        shapes.add(a["img0"].shape)
    # train crops to 128^2; the test split keeps the full frame
    assert shapes == ({(*CROP, 3)} if split == "train" else {(*HW, 3)})


def test_create_dataset_and_loader_equal_jax(tree):
    trn, val = create_dataset("vimeo_arb", tree, crop_size=[128, 128])
    assert isinstance(trn, VimeoArbitrary) and isinstance(val, VimeoArbitrary)
    assert (trn.split, val.split, trn.aug, trn.crop_size) == ("train", "test", True, CROP)
    assert len(trn) == len(val) == len(SEQS)
    for ds, split, shuffle in ((trn, "train", True), (val, "test", False)):
        ref = JaxVimeoArbitrary(tree, split=split, crop_size=CROP)
        for epoch in (0, 2):
            ours, theirs = DataLoader(ds, 2, shuffle=shuffle, seed=4), \
                JaxDataLoader(ref, 2, shuffle=shuffle, seed=4)
            ours.set_epoch(epoch)
            theirs.set_epoch(epoch)
            got, want = list(ours), list(theirs)
            assert len(got) == len(want) == 3
            for a, b in zip(got, want):
                _same(a, b)
                assert a["t"].shape == (2,) and a["t"].dtype == np.float32


def test_png_through_cv2_equals_pillow(tree, monkeypatch):
    path = f"{tree}/sequences/{SEQS[0]}/im1.png"
    with_pil = read_image(path)
    monkeypatch.setitem(sys.modules, "PIL", None)
    without = read_image(path)
    assert without.dtype == np.float32 and np.array_equal(without, with_pil)
    with pytest.raises(OSError, match="cannot read"):
        read_image(f"{tree}/missing.png")
