"""JAX parameter tree -> reference PyTorch state dict.

The inverse of `gimmvfi_tpu.utils.convert.convert_gimmvfi_r` /
`convert_raft`, written without importing the JAX package: it reads the
flax `params` / `batch_stats` nested dicts (numpy arrays or anything
`np.asarray` takes) and emits the reference key layout, which the port's
modules use as their own parameter names. Conv kernels go HWIO -> OIHW;
the HypoNet `linear_wb<i>` matrices go over as they are; the fixed
gaussian `g_filter` is not a parameter.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


class _Tree:
    """Reads flax paths ("a/b/c") and accumulates torch keys."""

    def __init__(self, params: Mapping, stats: Mapping):
        self.params = params
        self.stats = stats
        self.sd: dict[str, torch.Tensor] = {}

    @staticmethod
    def _node(root: Mapping, path: str):
        for part in path.split("/"):
            root = root[part]
        return root

    def _get(self, root: Mapping, path: str) -> np.ndarray:
        return np.asarray(self._node(root, path))

    def _put(self, key: str, value: np.ndarray):
        self.sd[key] = torch.tensor(np.asarray(value))

    def conv(self, tkey: str, fpath: str):
        """flax Conv2d at <fpath>/conv (HWIO kernel) -> torch OIHW."""
        self._put(f"{tkey}.weight", self._get(self.params, f"{fpath}/conv/kernel").transpose(3, 2, 0, 1))
        self._put(f"{tkey}.bias", self._get(self.params, f"{fpath}/conv/bias"))

    def prelu(self, tkey: str, fpath: str):
        self._put(f"{tkey}.weight", self._get(self.params, f"{fpath}/alpha"))

    def bn(self, tkey: str, fpath: str):
        self._put(f"{tkey}.weight", self._get(self.params, f"{fpath}/scale"))
        self._put(f"{tkey}.bias", self._get(self.params, f"{fpath}/bias"))
        self._put(f"{tkey}.running_mean", self._get(self.stats, f"{fpath}/mean"))
        self._put(f"{tkey}.running_var", self._get(self.stats, f"{fpath}/var"))

    def param(self, tkey: str, fpath: str):
        self._put(tkey, self._get(self.params, fpath))

    def conv_prelu(self, tkey: str, fpath: str):
        self.conv(f"{tkey}.0", f"{fpath}/conv")
        self.prelu(f"{tkey}.1", f"{fpath}/prelu")

    def lateral(self, tkey: str, fpath: str):
        self.conv(f"{tkey}.layers.0", f"{fpath}/conv_0")
        self.conv(f"{tkey}.layers.2", f"{fpath}/conv_2")

    def res_block(self, tkey: str, fpath: str):
        for i in (1, 2, 3, 4):
            self.conv_prelu(f"{tkey}.conv{i}", f"{fpath}/conv{i}")
        self.conv(f"{tkey}.conv5", f"{fpath}/conv5")
        self.prelu(f"{tkey}.prelu", f"{fpath}/prelu")


# --------------------------------------------------------------------- RAFT
def _basic_encoder(t: _Tree, tkey: str, fpath: str, batch_norm: bool):
    t.conv(f"{tkey}.conv1", f"{fpath}/conv1")
    if batch_norm:
        t.bn(f"{tkey}.norm1", f"{fpath}/norm1")
    for li in (1, 2, 3):
        for bi in (0, 1):
            bt, bf = f"{tkey}.layer{li}.{bi}", f"{fpath}/layer{li}_{bi}"
            t.conv(f"{bt}.conv1", f"{bf}/conv1")
            t.conv(f"{bt}.conv2", f"{bf}/conv2")
            if batch_norm:
                t.bn(f"{bt}.norm1", f"{bf}/norm1")
                t.bn(f"{bt}.norm2", f"{bf}/norm2")
            if "downsample" in t._node(t.params, bf):
                t.conv(f"{bt}.downsample.0", f"{bf}/downsample")
                if batch_norm:
                    t.bn(f"{bt}.downsample.1", f"{bf}/norm3")
    t.conv(f"{tkey}.conv2", f"{fpath}/conv2")


def _raft(t: _Tree, tprefix: str, fprefix: str):
    _basic_encoder(t, f"{tprefix}fnet", f"{fprefix}fnet", batch_norm=False)
    _basic_encoder(t, f"{tprefix}cnet", f"{fprefix}cnet", batch_norm=True)
    ub_t = f"{tprefix}update_block"
    ub_f = f"{fprefix}refine/update_block"
    for name in ("convc1", "convc2", "convf1", "convf2", "conv"):
        t.conv(f"{ub_t}.encoder.{name}", f"{ub_f}/encoder/{name}")
    for name in ("convz1", "convr1", "convq1", "convz2", "convr2", "convq2"):
        t.conv(f"{ub_t}.gru.{name}", f"{ub_f}/gru/{name}")
    t.conv(f"{ub_t}.flow_head.conv1", f"{ub_f}/flow_head/conv1")
    t.conv(f"{ub_t}.flow_head.conv2", f"{ub_f}/flow_head/conv2")
    t.conv(f"{ub_t}.mask.0", f"{fprefix}mask_head/mask_0")
    t.conv(f"{ub_t}.mask.2", f"{fprefix}mask_head/mask_2")


# ------------------------------------------------------------------ GIMM-VFI
def _upsample_head(t: _Tree, tkey: str, fpath: str, first_cr: int):
    for i in range(5):
        t.conv_prelu(f"{tkey}.{first_cr + i}", f"{fpath}/cr{i}")
    t.conv(f"{tkey}.{first_cr + 5}", f"{fpath}/proj")
    t.bn(f"{tkey}.{first_cr + 6}", f"{fpath}/bn")


def _decoder_convblock(t: _Tree, tkey: str, fpath: str):
    t.conv_prelu(f"{tkey}.0", f"{fpath}/cb0")
    for i in (1, 2, 3):
        t.res_block(f"{tkey}.{i}", f"{fpath}/cb{i}")
    t.conv(f"{tkey}.4", f"{fpath}/cb4")


def _update_block(t: _Tree, tkey: str, fpath: str):
    for name in ("convc1", "convc2", "convf1", "convf2", "conv"):
        t.conv(f"{tkey}.{name}", f"{fpath}/{name}")
    for seq in ("gru", "feat_head", "flow_head"):
        t.conv(f"{tkey}.{seq}.0", f"{fpath}/{seq}_0")
        t.conv(f"{tkey}.{seq}.2", f"{fpath}/{seq}_2")


def jax_raft_params_to_torch(params: Mapping[str, Any], batch_stats: Mapping[str, Any]):
    """flax RAFT (params, batch_stats) -> raft-things state dict layout."""
    t = _Tree(params, batch_stats)
    _raft(t, "", "")
    return t.sd


def jax_params_to_torch(params: Mapping[str, Any], batch_stats: Mapping[str, Any]):
    """flax GIMMVFI_R (params, batch_stats) -> gimmvfi_r state dict layout."""
    t = _Tree(params, batch_stats)
    _raft(t, "flow_estimator.", "flow_estimator/")
    for name in ("amt_last_cproj", "amt_second_last_cproj", "amt_fproj"):
        t.conv(name, name)
    _upsample_head(t, "amt_init_decoder.upsample", "amt_init_decoder/upsample", 1)
    _decoder_convblock(t, "amt_init_decoder.convblock", "amt_init_decoder")
    _upsample_head(t, "amt_final_decoder.upsample", "amt_final_decoder/upsample", 2)
    _decoder_convblock(t, "amt_final_decoder.convblock", "amt_final_decoder")
    _update_block(t, "amt_update4_low", "amt_update4_low")
    _update_block(t, "amt_update4_high", "amt_update4_high")
    t.conv("amt_comb_block.0", "amt_comb_block/conv_0")
    t.prelu("amt_comb_block.1", "amt_comb_block/prelu")
    t.conv("amt_comb_block.2", "amt_comb_block/conv_2")

    t.conv("cnn_encoder.0", "cnn_encoder/conv0")
    t.conv("cnn_encoder.1", "cnn_encoder/conv1")
    for i in (3, 4, 5):
        t.lateral(f"cnn_encoder.{i}", f"cnn_encoder/lateral{i}")
    t.conv("cnn_encoder.7", "cnn_encoder/conv7")
    t.conv("res_conv.0", "res_conv/conv0")
    t.conv("res_conv.1", "res_conv/conv1")
    t.lateral("res_conv.3", "res_conv/lateral3")
    t.conv("res_conv.5", "res_conv/conv5")
    for i in range(len(params["hyponet"])):
        t.param(f"hyponet.params_dict.linear_wb{i}", f"hyponet/linear_wb{i}")
    t.param("alpha_v", "alpha_v")
    t.param("alpha_fe", "alpha_fe")
    return t.sd


def load_jax_params(model: torch.nn.Module, params, batch_stats) -> torch.nn.Module:
    """Load a flax GIMMVFI_R tree into the port's GIMMVFI_R (strict)."""
    model.load_state_dict(jax_params_to_torch(params, batch_stats), strict=True)
    return model
