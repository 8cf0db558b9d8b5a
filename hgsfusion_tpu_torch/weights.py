"""Weights from the JAX package's variable trees.

``from_jax_variables`` turns the JAX package's ``{"params", "batch_stats"}``
tree of an HGSFusionModel (numpy arrays) into this package's ``state_dict``,
whose keys are the reference pcdet/torchvision names. It is the inverse of
the JAX package's ``train/torch_convert.py::convert_hgsfusion_state``. The
per-module functions convert the sub-tree of one JAX module into the
``state_dict`` of its counterpart here. ``from_jax_mask2former`` does the
same for the RHGM segmentor, the inverse of ``convert_mask2former_state``.

Layouts: flax conv kernel (kH, kW, I, O) -> torch (O, I, kH, kW); sparse
conv -> spconv's (O, kH, kW, I); dense (I, O) -> (O, I); flax BatchNorm
{scale, bias} + {mean, var} -> {weight, bias, running_mean, running_var,
num_batches_tracked}.
"""
from __future__ import annotations

import numpy as np
import torch


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(k):
    return _t(np.transpose(np.asarray(k), (3, 2, 0, 1)))


def _spconv(k):
    return _t(np.transpose(np.asarray(k), (3, 0, 1, 2)))


def _linear(k):
    return _t(np.transpose(np.asarray(k), (1, 0)))


def _prefix(prefix, sd):
    return {f"{prefix}.{k}": v for k, v in sd.items()}


def batch_norm(p, s):
    return {"weight": _t(p["scale"]), "bias": _t(p["bias"]),
            "running_mean": _t(s["mean"]), "running_var": _t(s["var"]),
            "num_batches_tracked": torch.tensor(0, dtype=torch.long)}


def conv(p, layout=_conv):
    out = {"weight": layout(p["kernel"])}
    if "bias" in p:
        out["bias"] = _t(p["bias"])
    return out


def conv_bn_relu(p, s):
    """layers.ConvBNReLU: ``conv``, ``bn``."""
    return {**_prefix("conv", conv(p["conv"])), **_prefix("bn", batch_norm(p["bn"], s["bn"]))}


def resnet_backbone(p, s):
    """resnet.ResNetDeepLabBackbone (torchvision names)."""
    out = {**_prefix("conv1", conv(p["conv1"])), **_prefix("bn1", batch_norm(p["bn1"], s["bn1"]))}
    for name in p:
        if not name.startswith("layer"):
            continue
        stage, block = name[len("layer"):].split("_block")
        t = f"layer{stage}.{block}"
        bp, bs = p[name], s[name]
        for i in (1, 2, 3):
            out.update(_prefix(f"{t}.conv{i}", conv(bp[f"conv{i}"])))
            out.update(_prefix(f"{t}.bn{i}", batch_norm(bp[f"bn{i}"], bs[f"bn{i}"])))
        if "downsample_conv" in bp:
            out.update(_prefix(f"{t}.downsample.0", conv(bp["downsample_conv"])))
            out.update(_prefix(f"{t}.downsample.1",
                               batch_norm(bp["downsample_bn"], bs["downsample_bn"])))
    return out


def frustum_to_voxel(p, s):
    """frustum.FrustumToVoxelMultiScale: ``channel_reduce.{0: Conv3d, 1: BN3d}``."""
    k = np.asarray(p["reduce_kernel"])  # (sum C, O)
    return {"channel_reduce.0.weight": _t(k.T[:, :, None, None, None]),
            "channel_reduce.0.bias": _t(p["reduce_bias"]),
            **_prefix("channel_reduce.1", batch_norm(p["bn"], s["bn"]))}


def pillar_feature_net(p, s):
    """pillar_encoder.PillarFeatureNet: ``pfn_layers.shared_mlps.{0, 1}``."""
    return {"pfn_layers.shared_mlps.0.weight": _linear(p["mlp_0"]["kernel"]),
            **_prefix("pfn_layers.shared_mlps.1", batch_norm(p["bn_0"], s["bn_0"]))}


def _subm(p, s):
    return {**_prefix("0", conv(p["conv"], _spconv)), **_prefix("1", batch_norm(p["bn"], s["bn"]))}


def pillar_net_radar(p, s):
    """bev_encoder.PillarNetRadar without its reader: ``backbone``, ``neck``."""
    bp, bs = p["backbone"], s["backbone"]
    out = {}
    for fname, tname, subs in (("conv1_block0", "conv1.0", ("conv0", "conv1", "conv2")),
                               ("conv1_block1", "conv1.1", ("conv1", "conv2"))):
        for sub in subs:
            out.update(_prefix(f"backbone.{tname}.{sub}", _subm(bp[fname][sub], bs[fname][sub])))
    for stage in ("conv2", "conv3", "conv4"):
        down = f"{stage}_down"
        out.update(_prefix(f"backbone.{stage}.0", conv(bp[down]["conv"], _spconv)))
        out.update(_prefix(f"backbone.{stage}.1", batch_norm(bp[down]["bn"], bs[down]["bn"])))
        for j, ti in ((0, 3), (1, 4)):
            fname = f"{stage}_block{j}"
            for sub in ("conv1", "conv2"):
                out.update(_prefix(f"backbone.{stage}.{ti}.{sub}",
                                   _subm(bp[fname][sub], bs[fname][sub])))
    np_, ns = p["neck"], s["neck"]
    for name in ("conv34", "conv23"):
        for j, (ci, bi) in enumerate(((0, 1), (3, 4))):
            out.update(_prefix(f"neck.{name}.{ci}", conv(np_[name][f"conv{j}"])))
            out.update(_prefix(f"neck.{name}.{bi}",
                               batch_norm(np_[name][f"bn{j}"], ns[name][f"bn{j}"])))
    return out


def conv2d_collapse(p, s):
    """occupancy.Conv2DCollapse: ``block.{conv, bn}``; kernel (C*Z, O)."""
    k = np.asarray(p["kernel"])
    out = {"block.conv.weight": _t(k.T[:, :, None, None]),
           **_prefix("block.bn", batch_norm(p["bn"], s["bn"]))}
    if "bias" in p:
        out["block.conv.bias"] = _t(p["bias"])
    return out


def radar_occupancy(p, s):
    """occupancy.RadarOccupancy2D (serial ASPP): ``pred_occupancy.*``."""
    out = {}
    for ci, bi, cname, bname in ((0, 1, "aspp_conv1", "aspp_bn1"),
                                 (3, 4, "aspp_conv2", "aspp_bn2"),
                                 (6, 7, "occ_conv1", "occ_bn1")):
        out.update(_prefix(f"pred_occupancy.{ci}", conv(p[cname])))
        out.update(_prefix(f"pred_occupancy.{bi}", batch_norm(p[bname], s[bname])))
    out.update(_prefix("pred_occupancy.9", conv(p["occ_conv2"])))
    return out


def fusion_after_bev(p, s):
    """fusion_bev.FusionAfterBEVSE: ``fuse_conv.{0, 1}``, ``se_block.att.1``."""
    return {**_prefix("fuse_conv.0", conv(p["fuse_conv"])),
            **_prefix("fuse_conv.1", batch_norm(p["fuse_bn"], s["fuse_bn"])),
            **_prefix("se_block.att.1", conv(p["se"]["att_conv"]))}


def anchor_head(p):
    """anchor_head.AnchorHeadSingle: ``conv_cls``, ``conv_box``, ``conv_dir_cls``."""
    return {k: v for name in ("conv_cls", "conv_box", "conv_dir_cls")
            for k, v in _prefix(name, conv(p[name])).items()}


def from_jax_variables(variables):
    """JAX HGSFusionModel variables {"params", "batch_stats"} -> state_dict."""
    p, s = variables["params"], variables["batch_stats"]
    image = "fusion_vfe.image_vfe"
    out = _prefix(f"{image}.ffn.ddn.model.backbone",
                  resnet_backbone(p["ddn_backbone"], s["ddn_backbone"]))
    for i in range(4):
        name = f"channel_reduce_{i}"
        out.update(_prefix(f"{image}.ffn.channel_reduce.{i}", conv_bn_relu(p[name], s[name])))
    out.update(_prefix(f"{image}.f2v", frustum_to_voxel(p["f2v"], s["f2v"])))
    out.update(_prefix("fusion_vfe.radar_backbone.reader",
                       pillar_feature_net(p["pillar_net"], s["pillar_net"])))
    out.update(_prefix("fusion_vfe.radar_backbone",
                       pillar_net_radar(p["radar_backbone"], s["radar_backbone"])))
    out.update(_prefix("fusion_vfe.radar_occupancy.map_to_bev",
                       conv2d_collapse(p["map_to_bev"], s["map_to_bev"])))
    out.update(_prefix("fusion_vfe.radar_occupancy",
                       radar_occupancy(p["radar_occupancy"], s["radar_occupancy"])))
    out.update(_prefix("fusion_after_bev",
                       fusion_after_bev(p["fusion_after_bev"], s["fusion_after_bev"])))
    out.update(_prefix("dense_head", anchor_head(p["dense_head"])))
    return out


# ---------------------------------------------------------------------------
# Mask2Former (RHGM mask source): the JAX package's Mask2FormerInstance
# variables -> rhgm.mask2former.Mask2FormerInstance's state_dict, whose names
# are the published checkpoint's; the inverse of the JAX package's
# train/torch_convert.py::convert_mask2former_state.
# ---------------------------------------------------------------------------

def layer_norm(p):
    """flax LayerNorm / GroupNorm {scale, bias} -> {weight, bias}."""
    return {"weight": _t(p["scale"]), "bias": _t(p["bias"])}


def swin_merge_perm(c: int) -> np.ndarray:
    """PatchMerging's 4C channel order: perm[i_jax] = i_published. The JAX
    package concatenates channel-major (mmcv unfold, c*4 + kh*2 + kw), the
    published weights position-major ([x(0::2, 0::2), x(1::2, 0::2),
    x(0::2, 1::2), x(1::2, 1::2)], pos*C + c)."""
    pos_rank = {(0, 0): 0, (1, 0): 1, (0, 1): 2, (1, 1): 3}
    perm = np.empty(4 * c, np.int64)
    for i in range(4 * c):
        ch, r = divmod(i, 4)
        perm[i] = pos_rank[divmod(r, 2)] * c + ch
    return perm


def _published_order(a, perm, axis: int = -1):
    """``a`` with its ``axis`` moved from the JAX order to the published one."""
    a = np.asarray(a)
    out = np.empty_like(a)
    idx = [slice(None)] * a.ndim
    idx[axis] = perm
    out[tuple(idx)] = a
    return out


def window_msa(p):
    """swin.WindowMSA (the JAX ``attn/w_msa``), with its index buffer."""
    from .models.swin import _rel_position_index

    table = np.asarray(p["relative_position_bias_table"])
    ws = (int(round(np.sqrt(table.shape[0]))) + 1) // 2
    return {"relative_position_bias_table": _t(table),
            "relative_position_index": torch.from_numpy(_rel_position_index(ws, ws)),
            **_prefix("qkv", conv(p["qkv"], _linear)), **_prefix("proj", conv(p["proj"], _linear))}


def swin_block(p):
    """swin.SwinBlock: ``norm1``, ``attn``, ``norm2``, ``mlp.{fc1, fc2}``."""
    return {**_prefix("norm1", layer_norm(p["norm1"])), **_prefix("attn", window_msa(p["attn"]["w_msa"])),
            **_prefix("norm2", layer_norm(p["norm2"])),
            **_prefix("mlp.fc1", conv(p["ffn"]["fc1"], _linear)),
            **_prefix("mlp.fc2", conv(p["ffn"]["fc2"], _linear))}


def patch_merging(p):
    """swin.PatchMerging, its 4C inputs in the published order."""
    perm = swin_merge_perm(np.asarray(p["norm"]["scale"]).shape[0] // 4)
    return {"norm.weight": _t(_published_order(p["norm"]["scale"], perm)),
            "norm.bias": _t(_published_order(p["norm"]["bias"], perm)),
            "reduction.weight": _t(_published_order(np.asarray(p["reduction"]["kernel"]).T, perm))}


def swin_transformer(p):
    """swin.SwinTransformer: ``patch_embed``, ``layers.{s}.blocks.{b}``,
    ``layers.{s}.downsample``, ``norm{i}``."""
    out = {**_prefix("patch_embed.proj", conv(p["patch_embed"]["projection"])),
           **_prefix("patch_embed.norm", layer_norm(p["patch_embed"]["norm"]))}
    for name, sub in p.items():
        if name.startswith("stage"):
            s, b = name[len("stage"):].split("_block")
            out.update(_prefix(f"layers.{s}.blocks.{b}", swin_block(sub)))
        elif name.startswith("downsample"):
            out.update(_prefix(f"layers.{name[len('downsample'):]}.downsample", patch_merging(sub)))
        elif name.startswith("norm"):
            out.update(_prefix(name, layer_norm(sub)))
    return out


def conv_gn(pc, pg):
    """mask2former._ConvGN (detectron2 Conv2d with a norm): ``weight``,
    ``norm.{weight, bias}``."""
    return {**conv(pc), **_prefix("norm", layer_norm(pg))}


def ms_deform_attn(p):
    """mask2former.MSDeformAttn."""
    return {k: v for sub in ("sampling_offsets", "attention_weights", "value_proj", "output_proj")
            for k, v in _prefix(sub, conv(p[sub], _linear)).items()}


def ms_deform_encoder_layer(p):
    """mask2former._MSDeformEncoderLayer."""
    return {**_prefix("self_attn", ms_deform_attn(p["self_attn"])),
            **_prefix("norm1", layer_norm(p["norm1"])), **_prefix("norm2", layer_norm(p["norm2"])),
            **_prefix("linear1", conv(p["linear1"], _linear)),
            **_prefix("linear2", conv(p["linear2"], _linear))}


def pixel_decoder_msdeform(p):
    """mask2former.PixelDecoderMSDeform: ``input_proj.{i}.{0, 1}``,
    ``transformer.{level_embed, encoder.layers.{i}}``, ``adapter_1``,
    ``layer_1``, ``mask_features``."""
    out = {"transformer.level_embed": _t(p["level_embed"])}
    for name, sub in p.items():
        if name.startswith("input_proj_") and name.endswith("_conv"):
            i = name[len("input_proj_"):-len("_conv")]
            out.update(_prefix(f"input_proj.{i}.0", conv(sub)))
            out.update(_prefix(f"input_proj.{i}.1", layer_norm(p[f"input_proj_{i}_gn"])))
        elif name.startswith("encoder_layer_"):
            out.update(_prefix(f"transformer.encoder.layers.{name[len('encoder_layer_'):]}",
                               ms_deform_encoder_layer(sub)))
    return {**out, **_prefix("adapter_1", conv_gn(p["adapter_1"], p["adapter_1_gn"])),
            **_prefix("layer_1", conv_gn(p["layer_1"], p["layer_1_gn"])),
            **_prefix("mask_features", conv(p["mask_features"]))}


def pixel_decoder_fpn(p):
    """mask2former.PixelDecoderFPN: the JAX ``output_{i}`` -> ``layer_{i+1}``,
    ``lateral_{i}`` -> ``adapter_{i+1}`` (detectron2 BasePixelDecoder's
    names), ``mask_features``."""
    out = _prefix("mask_features", conv(p["mask_features"]))
    for name, sub in p.items():
        for jax_name, port_name in (("output_", "layer_"), ("lateral_", "adapter_")):
            if name.startswith(jax_name):
                i = int(name[len(jax_name):])
                out.update(_prefix(f"{port_name}{i + 1}", conv_gn(sub["conv"], sub["gn"])))
    return out


def mha(p):
    """mask2former._MHA: flax q/k/v/proj -> torch MultiheadAttention's
    ``in_proj_weight`` rows [Wq; Wk; Wv], ``in_proj_bias``, ``out_proj``."""
    return {"in_proj_weight": _t(np.concatenate([np.asarray(p[s]["kernel"]).T for s in "qkv"])),
            "in_proj_bias": _t(np.concatenate([np.asarray(p[s]["bias"]) for s in "qkv"])),
            **_prefix("out_proj", conv(p["proj"], _linear))}


def masked_transformer_decoder(p):
    """mask2former.MaskedTransformerDecoder (the published predictor's names)."""
    out = {f"{name}.weight": _t(p[name]) for name in ("query_feat", "query_embed", "level_embed")}
    n_layers = sum(1 for k in p if k.endswith("_cross"))
    for li in range(n_layers):
        out.update(_prefix(f"transformer_cross_attention_layers.{li}", {
            **_prefix("multihead_attn", mha(p[f"layer{li}_cross"])),
            **_prefix("norm", layer_norm(p[f"layer{li}_cross_norm"]))}))
        out.update(_prefix(f"transformer_self_attention_layers.{li}", {
            **_prefix("self_attn", mha(p[f"layer{li}_self"])),
            **_prefix("norm", layer_norm(p[f"layer{li}_self_norm"]))}))
        out.update(_prefix(f"transformer_ffn_layers.{li}", {
            **_prefix("linear1", conv(p[f"layer{li}_ffn0"], _linear)),
            **_prefix("linear2", conv(p[f"layer{li}_ffn1"], _linear)),
            **_prefix("norm", layer_norm(p[f"layer{li}_ffn_norm"]))}))
    out.update(_prefix("decoder_norm", layer_norm(p["decoder_norm"])))
    out.update(_prefix("class_embed", conv(p["class_embed"], _linear)))
    for i in range(3):
        out.update(_prefix(f"mask_embed.layers.{i}", conv(p["mask_embed"][f"fc{i}"], _linear)))
    return out


def from_jax_mask2former(variables):
    """JAX Mask2FormerInstance variables {"params"} (numpy) -> state_dict of
    rhgm.mask2former.Mask2FormerInstance, either pixel decoder."""
    p = variables["params"]
    pd = p["pixel_decoder"]
    pd_sd = pixel_decoder_msdeform(pd) if "level_embed" in pd else pixel_decoder_fpn(pd)
    return {**_prefix("backbone", swin_transformer(p["backbone"])),
            **_prefix("sem_seg_head.pixel_decoder", pd_sd),
            **_prefix("sem_seg_head.predictor", masked_transformer_decoder(p["transformer_decoder"]))}
