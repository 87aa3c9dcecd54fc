"""JAX parameter tree -> reference PyTorch state dict.

The inverse of `gimmvfi_tpu.utils.convert.convert_gimmvfi_r` /
`convert_raft` / `convert_gimmvfi_f` / `convert_flowformer`, written
without importing the JAX package: it reads the flax `params` /
`batch_stats` nested dicts (numpy arrays or anything `np.asarray` takes)
and emits the reference key layout, which the port's modules use as their
own parameter names. Conv kernels go HWIO -> OIHW, Dense kernels are
transposed, LayerNorm scales become weights; the HypoNet `linear_wb<i>`
matrices go over as they are; the fixed gaussian `g_filter`, FlowFormer's
dead Twins stage norm and GMA's unused position embedding are not
parameters.
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

    def raw_conv(self, tkey: str, fpath: str, bias: bool = True):
        """flax nn.Conv directly at <fpath> (no Conv2d wrapper) -> torch OIHW."""
        self._put(f"{tkey}.weight", self._get(self.params, f"{fpath}/kernel").transpose(3, 2, 0, 1))
        if bias:
            self._put(f"{tkey}.bias", self._get(self.params, f"{fpath}/bias"))

    def linear(self, tkey: str, fpath: str):
        """flax Dense kernel (in, out) -> torch nn.Linear weight (out, in)."""
        self._put(f"{tkey}.weight", self._get(self.params, f"{fpath}/kernel").T)
        self._put(f"{tkey}.bias", self._get(self.params, f"{fpath}/bias"))

    def ln(self, tkey: str, fpath: str):
        """flax LayerNorm (scale, bias) -> torch nn.LayerNorm (weight, bias)."""
        self._put(f"{tkey}.weight", self._get(self.params, f"{fpath}/scale"))
        self._put(f"{tkey}.bias", self._get(self.params, f"{fpath}/bias"))

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
    _amt_and_gimm(t, params)
    return t.sd


def _amt_and_gimm(t: _Tree, params: Mapping[str, Any]):
    """The AMT decoders and the GIMM motion modules, shared by R and F."""
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


# -------------------------------------------------------------- FlowFormer
def _twins_svt(t: _Tree, tkey: str, fpath: str, depths=(2, 2)):
    """Twins-SVT (2 stages) at <fpath> -> `<tkey>.svt.*`; the dead final
    stage norm is not a parameter of the port."""
    tkey = f"{tkey}.svt"
    for i, depth in enumerate(depths):
        t.raw_conv(f"{tkey}.patch_embeds.{i}.proj", f"{fpath}/patch_embeds_{i}/proj")
        t.ln(f"{tkey}.patch_embeds.{i}.norm", f"{fpath}/patch_embeds_{i}/norm")
        for j in range(depth):
            bt, bf = f"{tkey}.blocks.{i}.{j}", f"{fpath}/blocks_{i}_{j}"
            t.ln(f"{bt}.norm1", f"{bf}/norm1")
            t.ln(f"{bt}.norm2", f"{bf}/norm2")
            if j % 2 == 0:
                t.linear(f"{bt}.attn.qkv", f"{bf}/attn/qkv")
            else:
                t.linear(f"{bt}.attn.q", f"{bf}/attn/q")
                t.linear(f"{bt}.attn.kv", f"{bf}/attn/kv")
                t.raw_conv(f"{bt}.attn.sr", f"{bf}/attn/sr")
                t.ln(f"{bt}.attn.norm", f"{bf}/attn/norm")
            t.linear(f"{bt}.attn.proj", f"{bf}/attn/proj")
            t.linear(f"{bt}.mlp.fc1", f"{bf}/mlp/fc1")
            t.linear(f"{bt}.mlp.fc2", f"{bf}/mlp/fc2")
        t.raw_conv(f"{tkey}.pos_block.{i}.proj.0", f"{fpath}/pos_block_{i}/proj_0")


def _attn_ffn(t: _Tree, tkey: str, fpath: str, names=("q", "k", "v", "proj")):
    t.ln(f"{tkey}.norm1", f"{fpath}/norm1")
    t.ln(f"{tkey}.norm2", f"{fpath}/norm2")
    for name in names:
        t.linear(f"{tkey}.{name}", f"{fpath}/{name}")
    t.linear(f"{tkey}.ffn.0", f"{fpath}/ffn/fc0")
    t.linear(f"{tkey}.ffn.3", f"{fpath}/ffn/fc3")


def _vertical_block(t: _Tree, tkey: str, fpath: str, is_global: bool):
    t.ln(f"{tkey}.norm1", f"{fpath}/norm1")
    t.ln(f"{tkey}.norm2", f"{fpath}/norm2")
    for name in ("context_proj", "q", "k", "v", "proj"):
        t.linear(f"{tkey}.attn.{name}", f"{fpath}/attn/{name}")
    if is_global:
        t.raw_conv(f"{tkey}.attn.sr_key", f"{fpath}/attn/sr_key")
        t.raw_conv(f"{tkey}.attn.sr_value", f"{fpath}/attn/sr_value")
        t.ln(f"{tkey}.attn.norm", f"{fpath}/attn/norm")
    t.linear(f"{tkey}.mlp.fc1", f"{fpath}/mlp_fc1")
    t.linear(f"{tkey}.mlp.fc2", f"{fpath}/mlp_fc2")


def _cost_perceiver(t: _Tree, tkey: str, fpath: str, depth: int = 3):
    pe_t, pe_f = f"{tkey}.patch_embed", f"{fpath}/patch_embed"
    for i in (0, 2, 4):
        t.raw_conv(f"{pe_t}.proj.{i}", f"{pe_f}/proj_{i}")
    for i in (0, 2):
        t.raw_conv(f"{pe_t}.ffn_with_coord.{i}", f"{pe_f}/ffn_{i}")
    t.ln(f"{pe_t}.norm", f"{pe_f}/norm")
    t.param(f"{tkey}.latent_tokens", f"{fpath}/latent_tokens")
    _attn_ffn(t, f"{tkey}.input_layer", f"{fpath}/input_layer")
    for i in range(depth):
        _attn_ffn(t, f"{tkey}.encoder_layers.{i}", f"{fpath}/encoder_layers_{i}")
        vt, vf = f"{tkey}.vertical_encoder_layers.{i}", f"{fpath}/vertical_encoder_layers_{i}"
        _vertical_block(t, f"{vt}.local_block", f"{vf}/local_block", False)
        _vertical_block(t, f"{vt}.global_block", f"{vf}/global_block", True)


def _memory_decoder(t: _Tree, tkey: str, fpath: str):
    """The decoder; its loop-invariant k/v (`<fpath>/cross_k`, `cross_v`) and
    the once-applied mask head (`<fpath>/mask_head`) keep the reference's
    keys inside the cross-attention and the update block."""
    t.conv(f"{tkey}.proj", f"{fpath}/proj")
    t.raw_conv(f"{tkey}.att.to_qk", f"{fpath}/att/to_qk", bias=False)
    cross_t, step = f"{tkey}.decoder_layer.cross_attend", f"{fpath}/step"
    t.linear(f"{cross_t}.k", f"{fpath}/cross_k")
    t.linear(f"{cross_t}.v", f"{fpath}/cross_v")
    _attn_ffn(t, cross_t, f"{step}/cross", names=("q", "proj"))
    t.conv(f"{tkey}.flow_token_encoder.0", f"{step}/flow_token_encoder_0")
    t.conv(f"{tkey}.flow_token_encoder.2", f"{step}/flow_token_encoder_2")
    ub_t, ub_f = f"{tkey}.update_block", f"{step}/update_block"
    for name in ("convc1", "convc2", "convf1", "convf2", "conv"):
        t.conv(f"{ub_t}.encoder.{name}", f"{ub_f}/encoder/{name}")
    for name in ("convz1", "convr1", "convq1", "convz2", "convr2", "convq2"):
        t.conv(f"{ub_t}.gru.{name}", f"{ub_f}/gru/{name}")
    t.conv(f"{ub_t}.flow_head.conv1", f"{ub_f}/flow_head_conv1")
    t.conv(f"{ub_t}.flow_head.conv2", f"{ub_f}/flow_head_conv2")
    t.conv(f"{ub_t}.mask.0", f"{fpath}/mask_head/mask_0")
    t.conv(f"{ub_t}.mask.2", f"{fpath}/mask_head/mask_2")
    t.raw_conv(f"{ub_t}.aggregator.to_v", f"{ub_f}/aggregator/to_v", bias=False)
    t.param(f"{ub_t}.aggregator.gamma", f"{ub_f}/aggregator/gamma")


def _flowformer(t: _Tree, tprefix: str, fprefix: str):
    _twins_svt(t, f"{tprefix}context_encoder", f"{fprefix}context_encoder")
    me_t, me_f = f"{tprefix}memory_encoder", f"{fprefix}memory_encoder"
    _twins_svt(t, f"{me_t}.feat_encoder", f"{me_f}/feat_encoder")
    t.raw_conv(f"{me_t}.channel_convertor", f"{me_f}/channel_convertor", bias=False)
    _cost_perceiver(t, f"{me_t}.cost_perceiver_encoder", f"{me_f}/cost_perceiver_encoder")
    _memory_decoder(t, f"{tprefix}memory_decoder", f"{fprefix}memory_decoder")


def jax_flowformer_params_to_torch(params: Mapping[str, Any]):
    """flax FlowFormer params -> the reference FlowFormer state dict layout
    (the inverse of `gimmvfi_tpu.utils.convert.convert_flowformer`)."""
    t = _Tree(params, {})
    _flowformer(t, "", "")
    return t.sd


def jax_gimmvfi_f_params_to_torch(params: Mapping[str, Any], batch_stats: Mapping[str, Any]):
    """flax GIMMVFI_F (params, batch_stats) -> gimmvfi_f state dict layout
    (the inverse of `convert_gimmvfi_f`: R's layout with FlowFormer in place
    of RAFT and no projections)."""
    t = _Tree(params, batch_stats)
    _flowformer(t, "flow_estimator.", "flow_estimator/")
    _amt_and_gimm(t, params)
    return t.sd


def load_jax_params(model: torch.nn.Module, params, batch_stats) -> torch.nn.Module:
    """Load a flax GIMMVFI_R or GIMMVFI_F tree (F has no `amt_fproj`) into
    the port's model of the same family (strict)."""
    convert = jax_params_to_torch if "amt_fproj" in params else jax_gimmvfi_f_params_to_torch
    model.load_state_dict(convert(params, batch_stats), strict=True)
    return model
