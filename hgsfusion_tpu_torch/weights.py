"""Weights from the JAX package's variable trees.

``from_jax_variables`` turns the JAX package's ``{"params", "batch_stats"}``
tree of a detector (numpy arrays) into this package's ``state_dict``, whose
keys are the reference pcdet/torchvision names where the JAX package's
``train/torch_convert.py::convert_hgsfusion_state`` maps them (of which it
is the inverse), else the JAX package's own. The
per-module functions convert the sub-tree of one JAX module into the
``state_dict`` of its counterpart here. ``from_jax_mask2former`` does the
same for the RHGM segmentor, the inverse of ``convert_mask2former_state``.

Layouts: flax conv kernel (kH, kW, I, O) -> torch (O, I, kH, kW); sparse
conv -> spconv's (O, kH, kW, I) (3-D: (O, kD, kH, kW, I); the VoxelNeXt
backbones' ``conv_out`` / ``shared_conv``, flax ``nn.Conv`` kernels in JAX,
are sparse convs in the reference and take this layout); dense (I, O) ->
(O, I); flax attention q/k/v (I, heads, head_dim) -> torch
``MultiheadAttention``'s packed rows; flax BatchNorm
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
    return _t(np.moveaxis(np.asarray(k), -1, 0))


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


def deeplab_classifier(p, s):
    """resnet.DeepLabClassifier (torchvision ``DeepLabHead`` names): the JAX
    ``aspp/b{0..3}`` -> ``0.convs.{0..3}``, ``pool`` -> ``0.convs.4``,
    ``project`` -> ``0.project``, ``conv``/``bn`` -> ``1``/``2``, ``logits``
    -> ``4``."""
    ap, as_ = p["aspp"], s["aspp"]
    out = {}
    for i in range(4):
        out.update(_prefix(f"0.convs.{i}.0", conv(ap[f"b{i}_conv"])))
        out.update(_prefix(f"0.convs.{i}.1", batch_norm(ap[f"b{i}_bn"], as_[f"b{i}_bn"])))
    out.update(_prefix("0.convs.4.1", conv(ap["pool_conv"])))
    out.update(_prefix("0.convs.4.2", batch_norm(ap["pool_bn"], as_["pool_bn"])))
    out.update(_prefix("0.project.0", conv(ap["project_conv"])))
    out.update(_prefix("0.project.1", batch_norm(ap["project_bn"], as_["project_bn"])))
    return {**out, **_prefix("1", conv(p["conv"])), **_prefix("2", batch_norm(p["bn"], s["bn"])),
            **_prefix("4", conv(p["logits"]))}


def frustum_to_voxel(p, s):
    """frustum.FrustumToVoxelMultiScale: ``channel_reduce.{0: Conv3d, 1: BN3d}``."""
    k = np.asarray(p["reduce_kernel"])  # (sum C, O)
    return {"channel_reduce.0.weight": _t(k.T[:, :, None, None, None]),
            "channel_reduce.0.bias": _t(p["reduce_bias"]),
            **_prefix("channel_reduce.1", batch_norm(p["bn"], s["bn"]))}


def pillar_feature_net(p, s):
    """pillar_encoder.PillarFeatureNet: layer i's ``mlp_i`` / ``bn_i`` ->
    ``pfn_layers.shared_mlps.{3i, 3i + 1}``."""
    out = {}
    for i in range(sum(1 for k in p if k.startswith("mlp_"))):
        out[f"pfn_layers.shared_mlps.{3 * i}.weight"] = _linear(p[f"mlp_{i}"]["kernel"])
        out.update(_prefix(f"pfn_layers.shared_mlps.{3 * i + 1}",
                           batch_norm(p[f"bn_{i}"], s[f"bn_{i}"])))
    return out


def _conv_transpose(k):
    """flax ConvTranspose kernel (kH, kW, I, O), applied without flipping,
    -> torch ConvTranspose2d (I, O, kH, kW), which applies it flipped."""
    return _t(np.transpose(np.asarray(k)[::-1, ::-1], (2, 3, 0, 1)))


def conv_bn_layers(p, s):
    """base_bev_backbone.BaseBEVBackbone / RPNV2 (the JAX names kept):
    ``{name}_conv`` (transposed where the name is a ``deblock`` of a
    stride, its kernel 2-D) and ``{name}_bn``."""
    out = {}
    for name in p:
        if name.endswith("_bn"):
            out.update(_prefix(name, batch_norm(p[name], s[name])))
        elif name.startswith("deblock") and not name.startswith("deblock4"):
            out[f"{name}.weight"] = _conv_transpose(p[name]["kernel"])
        else:
            out.update(_prefix(name, conv(p[name])))
    return out


def anchor_head_multi(p, s):
    """anchor_head.AnchorHeadMulti (the JAX names kept): ``shared_conv``,
    ``shared_bn``, ``head_{i}.{part}_mid{k}_conv`` / ``_bn``,
    ``head_{i}.conv_*``."""
    out = {}
    for name, sub in p.items():
        if name == "shared_bn":
            out.update(_prefix(name, batch_norm(sub, s[name])))
        elif name == "shared_conv":
            out.update(_prefix(name, conv(sub)))
        else:  # head_{i}
            for part, q in sub.items():
                out.update(_prefix(f"{name}.{part}", batch_norm(q, s[name][part])
                                   if part.endswith("_bn") else conv(q)))
    return out


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


def deform_conv(p):
    """ops/deform_conv.ModulatedDeformConv2d: ``weight`` from the JAX kernel
    (k^2, C, O), ``conv_offset``."""
    k = np.asarray(p["kernel"])
    side = int(round(k.shape[0] ** 0.5))
    out = {"weight": _conv(k.reshape(side, side, *k.shape[1:])),
           **_prefix("conv_offset", conv(p["conv_offset"]))}
    if "bias" in p:
        out["bias"] = _t(p["bias"])
    return out


def radar_occupancy(p, s):
    """occupancy.RadarOccupancy2D: ``pred_occupancy.*`` (the serial ASPP at
    0-4, the tail at 6-9); the parallel ASPP and the SE gate under the JAX
    package's names."""
    out = {}
    layers = [(6, 7, "occ_conv1", "occ_bn1")]
    if "aspp_conv1" in p:
        layers = [(0, 1, "aspp_conv1", "aspp_bn1"), (3, 4, "aspp_conv2", "aspp_bn2")] + layers
    for ci, bi, cname, bname in layers:
        out.update(_prefix(f"pred_occupancy.{ci}", conv(p[cname])))
        out.update(_prefix(f"pred_occupancy.{bi}", batch_norm(p[bname], s[bname])))
    out.update(_prefix("pred_occupancy.9", conv(p["occ_conv2"])))
    for name in p:
        if name.startswith("aspp_dcn"):
            out.update(_prefix(name, deform_conv(p[name])))
        elif name.startswith("aspp_branch_bn") or name in ("aspp_fuse_bn", "se_squeeze_bn"):
            out.update(_prefix(name, batch_norm(p[name], s[name])))
        elif name.startswith("aspp_branch") or name in ("aspp_fuse", "se_squeeze_conv"):
            out.update(_prefix(name, conv(p[name])))
        elif name == "se":
            out.update(_prefix("se.att.1", conv(p["se"]["att_conv"])))
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


def voxel_backbone(p, s):
    """voxel_backbone.VoxelBackBone8x (pcdet names): ``conv_input``,
    ``conv1.0``, ``conv{i}.{0, 1, 2}`` from the JAX ``conv{i}_down``,
    ``_a``, ``_b``, ``conv_out``; each block ``0`` the convolution, ``1``
    the BN; VoxelBackBone8xFocal's ``focal{1,2,3}`` by their own names."""
    names = {"conv_input": "conv_input", "conv1": "conv1.0", "conv_out": "conv_out"}
    for i in (2, 3, 4):
        names.update({f"conv{i}_down": f"conv{i}.0", f"conv{i}_a": f"conv{i}.1",
                      f"conv{i}_b": f"conv{i}.2"})
    out = {}
    for jax_name, name in names.items():
        out.update(_prefix(f"{name}.0", conv(p[jax_name]["conv"], _spconv)))
        out.update(_prefix(f"{name}.1", batch_norm(p[jax_name]["bn"], s[jax_name]["bn"])))
    for name in ("focal1", "focal2", "focal3"):  # VoxelBackBone8xFocal
        if name in p:
            out.update(_prefix(name, focal_conv(p[name], s[name])))
    return out


def focal_conv(p, s):
    """focal_conv.FocalSparseConv3D: ``conv_imp``, ``conv`` (spconv layout),
    ``bn1``."""
    return {**_prefix("conv_imp", conv(p["conv_imp"], _spconv)),
            **_prefix("conv", conv(p["conv"], _spconv)),
            **_prefix("bn1", batch_norm(p["bn1"], s["bn1"]))}


def linear_bn_stack(p, s):
    """Linear (flax ``Dense``) and BatchNorm1d modules by their JAX names,
    nested to any depth (a module with a 2-D kernel is a Linear, with a 5-D
    one a 3-D convolution in spconv's layout, one with a scale a
    BatchNorm): ``GroupMLP``, ``RCNNHead``, ``SECONDIoUHead``,
    the RoI-grid pools (``roi_heads.VoxelRCNNPool``'s
    ``pool_x_conv{i}.mlp_r{j}``, ``pvrcnn.RoIGridPool``'s ``pool.mlp_r{j}``
    or ``pool_vp``), PV-RCNN's ``pfe`` (``sa_*`` / ``vp_*``, ``fusion_fc``,
    ``fusion_bn``) and ``point_head``, Part-A2's ``point_head`` and
    ``roi_head`` (``conv_part{i}`` / ``conv_rpn{i}`` and their masked BNs
    among its FC stacks)."""
    out = {}
    for n, sub in p.items():
        if "kernel" in sub:
            out.update(_prefix(n, conv(sub, _spconv if np.ndim(sub["kernel"]) == 5
                                       else _linear)))
        elif "scale" in sub:
            out.update(_prefix(n, batch_norm(sub, s[n])))
        else:
            out.update(_prefix(n, linear_bn_stack(sub, s.get(n, {}))))
    return out


def center_head(p, s):
    """center_head.CenterHead (the JAX names): ``shared_conv``,
    ``shared_bn``, ``head.{name}_conv{i}`` / ``_bn{i}`` / ``_out``."""
    out = {**_prefix("shared_conv", conv(p["shared_conv"])),
           **_prefix("shared_bn", batch_norm(p["shared_bn"], s["shared_bn"]))}
    for name, sub in p["head"].items():
        out.update(_prefix(f"head.{name}", batch_norm(sub, s["head"][name]) if "_bn" in name
                           else conv(sub)))
    return out


def _sparse_basic_block(p, s):
    """bev_encoder.SparseBasicBlock: ``conv1``, ``conv2`` (each 0 conv, 1 BN)."""
    return {k: v for sub in ("conv1", "conv2")
            for k, v in _prefix(sub, _subm(p[sub], s[sub])).items()}


def _sparse_stages(p, s, stages):
    """The 2-D sparse backbones' stages: ``conv1_block{j}`` -> ``conv1.{j}``;
    ``conv{i}_down`` -> ``conv{i}.{0, 1}`` and ``conv{i}_block{j}`` ->
    ``conv{i}.{3 + j}`` (bev_encoder._DownStage). A residual block's JAX
    tree has ``conv1``/``conv2``, a post-activation one ``convbn``."""
    def block(q, t):
        return _subm(q["convbn"], t["convbn"]) if "convbn" in q else _sparse_basic_block(q, t)

    out = {}
    for stage in stages:
        first = 0 if stage == "conv1" else 3
        if stage != "conv1":
            down = f"{stage}_down"
            out.update(_prefix(f"{stage}.0", conv(p[down]["conv"], _spconv)))
            out.update(_prefix(f"{stage}.1", batch_norm(p[down]["bn"], s[down]["bn"])))
        j = 0
        while f"{stage}_block{j}" in p:
            name = f"{stage}_block{j}"
            out.update(_prefix(f"{stage}.{first + j}", block(p[name], s[name])))
            j += 1
    return out


def pillar_res18_backbone(p, s):
    """sparse_backbone_2d.PillarRes18BackBone8x (either kind): the sparse
    stages (``_sparse_stages``), then ``conv5``: 0 from ``conv5_down``
    (``conv``, ``bn``), 1-2 from ``conv5_block{j}`` (``conv1``/``bn1``/
    ``conv2``/``bn2``, or ``conv``/``bn``), dense layouts."""
    out = _sparse_stages(p, s, ("conv1", "conv2", "conv3", "conv4"))
    for i, name in enumerate(("conv5_down", "conv5_block0", "conv5_block1")):
        for part, q in p[name].items():
            out.update(_prefix(f"conv5.{i}.{part}", batch_norm(q, s[name][part]) if "bn" in part
                               else conv(q)))
    return out


def _conv_out_shared(p, s):
    """The VoxelNeXt backbones' tail: ``conv_out`` / ``conv_out_bn`` ->
    ``conv_out.{0, 1}``, ``shared_conv`` / ``shared_bn`` ->
    ``shared_conv.{0, 1}``; the convolutions sparse (spconv layout)."""
    return {**_prefix("conv_out.0", conv(p["conv_out"], _spconv)),
            **_prefix("conv_out.1", batch_norm(p["conv_out_bn"], s["conv_out_bn"])),
            **_prefix("shared_conv.0", conv(p["shared_conv"], _spconv)),
            **_prefix("shared_conv.1", batch_norm(p["shared_bn"], s["shared_bn"]))}


def voxelnext2d_backbone(p, s):
    """sparse_backbone_2d.VoxelNeXt2DBackbone: six stages and the tail."""
    return {**_sparse_stages(p, s, ("conv1",) + tuple(f"conv{i}" for i in range(2, 7))),
            **_conv_out_shared(p, s)}


def voxelnext_backbone(p, s):
    """voxel_backbone.VoxelResBackBone8xVoxelNeXt: ``conv_input``;
    ``conv{i}_res{j}`` (``a_conv``/``a_bn``/``b_conv``/``b_bn``) ->
    ``conv{i}.{j (+1 past a strided block)}.{conv1, bn1, conv2, bn2}``;
    ``conv{i}_down`` -> ``conv{i}.0``; the tail."""
    out = {**_prefix("conv_input", _subm(p["conv_input"], s["conv_input"]))}
    for i in range(1, 7):
        first = 0 if i == 1 else 1
        if i > 1:
            out.update(_prefix(f"conv{i}.0", _subm(p[f"conv{i}_down"], s[f"conv{i}_down"])))
        for j in range(2):
            q, t = p[f"conv{i}_res{j}"], s[f"conv{i}_res{j}"]
            for jax_part, part in (("a", "1"), ("b", "2")):
                out.update(_prefix(f"conv{i}.{first + j}.conv{part}",
                                   conv(q[f"{jax_part}_conv"], _spconv)))
                out.update(_prefix(f"conv{i}.{first + j}.bn{part}",
                                   batch_norm(q[f"{jax_part}_bn"], t[f"{jax_part}_bn"])))
    return {**out, **_conv_out_shared(p, s)}


def backbone_3d(p, s):
    """The ``backbone_3d`` of CenterPoint, SECOND (either), Voxel R-CNN,
    SECOND-IoU and VoxelNeXt, told apart
    by its JAX modules."""
    if "conv1_res0" in p:
        return voxelnext_backbone(p, s)
    if "conv6_down" in p:
        return voxelnext2d_backbone(p, s)
    if "conv5_down" in p:
        return pillar_res18_backbone(p, s)
    return voxel_backbone(p, s)


def unet_decoder(p, s):
    """parta2.UNetDecoder: ``up{4,3,2}_{a,b}`` (each ``0`` the convolution,
    spconv layout, ``1`` its BN)."""
    return {k: v for name in p for k, v in _prefix(name, _subm(p[name], s[name])).items()}


def _backbone_families(p, s):
    """CenterPointModel, SECONDModel (the focal one too), VoxelRCNNModel,
    SECONDIoUModel, PVRCNNModel, PVRCNNPlusPlusModel, PartA2Model and
    VoxelNeXtModel: ``pillar_net``, ``backbone_3d``, ``backbone_2d``,
    ``unet_decoder``, ``pfe``, ``point_head``, ``roi_grid_pool`` and
    ``roi_head`` where the model has them, and the ``dense_head`` (a
    CenterHead or an AnchorHeadSingle)."""
    out = {}
    if "pillar_net" in p:
        out.update(_prefix("pillar_net", pillar_feature_net(p["pillar_net"], s["pillar_net"])))
    if "backbone_3d" in p:
        out.update(_prefix("backbone_3d", backbone_3d(p["backbone_3d"], s["backbone_3d"])))
    if "backbone_2d" in p:
        out.update(_prefix("backbone_2d", conv_bn_layers(p["backbone_2d"], s["backbone_2d"])))
    if "unet_decoder" in p:
        out.update(_prefix("unet_decoder", unet_decoder(p["unet_decoder"], s["unet_decoder"])))
    # PV-RCNN(++), Voxel R-CNN, Part-A2; the RCNNHead, SECOND-IoU's head
    for name in ("pfe", "point_head", "roi_grid_pool", "roi_head"):
        if name in p:
            out.update(_prefix(name, linear_bn_stack(p[name], s.get(name, {}))))
    head = p["dense_head"]
    return {**out, **_prefix("dense_head", center_head(head, s["dense_head"]) if "head" in head
                             else anchor_head(head))}


def flax_attention(p):
    """transfusion_head.MultiheadAttention from flax
    ``MultiHeadDotProductAttention``: ``query``/``key``/``value`` kernels
    (I, heads, head_dim) -> rows [Wq; Wk; Wv], ``out`` (heads, head_dim, O)."""
    def rows(k):
        k = np.asarray(k)
        return k.reshape(k.shape[0], -1).T

    out = np.asarray(p["out"]["kernel"])
    return {"in_proj_weight": _t(np.concatenate([rows(p[n]["kernel"])
                                                 for n in ("query", "key", "value")])),
            "in_proj_bias": _t(np.concatenate([np.asarray(p[n]["bias"]).reshape(-1)
                                               for n in ("query", "key", "value")])),
            "out_proj.weight": _t(out.reshape(-1, out.shape[-1]).T),
            "out_proj.bias": _t(p["out"]["bias"])}


def _mlp_bn(p, s, names):
    """Linear / BatchNorm1d leaves by their JAX names."""
    out = {}
    for n in names:
        out.update(_prefix(n, batch_norm(p[n], s[n]) if n == "bn" else conv(p[n], _linear)))
    return out


def transfusion_head(p, s):
    """transfusion_head.TransFusionHead (the JAX names)."""
    out = {**_prefix("shared_conv", conv(p["shared_conv"])),
           **_prefix("hm_conv1", conv(p["hm_conv1"])),
           **_prefix("hm_bn", batch_norm(p["hm_bn"], s["hm_bn"])),
           **_prefix("hm_out", conv(p["hm_out"])),
           **_prefix("class_encoding", conv(p["class_encoding"], _linear))}
    dp, ds = p["decoder"], s["decoder"]
    for n in ("self_posembed", "cross_posembed"):
        out.update(_prefix(f"decoder.{n}", _mlp_bn(dp[n], ds[n], ("fc1", "bn", "fc2"))))
    for n in ("self_attn", "cross_attn"):
        out.update(_prefix(f"decoder.{n}", flax_attention(dp[n])))
    for n in ("norm1", "norm2", "norm3"):
        out.update(_prefix(f"decoder.{n}", layer_norm(dp[n])))
    for n in ("linear1", "linear2"):
        out.update(_prefix(f"decoder.{n}", conv(dp[n], _linear)))
    for n in ("center", "height", "dim", "rot", "heatmap"):
        out.update(_prefix(n, _mlp_bn(p[n], s[n], ("fc", "bn", "out"))))
    return out


def generalized_lss_fpn(p, s):
    """swin.GeneralizedLSSFPN: the JAX ``lateral_{i}`` / ``fpn_{i}`` ->
    ``lateral_convs.{i}`` / ``fpn_convs.{i}``."""
    out = {}
    for name in p:
        kind, i = name.rsplit("_", 1)
        out.update(_prefix(f"{'lateral_convs' if kind == 'lateral' else 'fpn_convs'}.{i}",
                           conv_bn_relu(p[name], s[name])))
    return out


def _bevfusion(p, s):
    """BEVFusionModel (either camera branch)."""
    if "image_backbone" in p:
        out = {**_prefix("image_backbone", swin_transformer(p["image_backbone"])),
               **_prefix("neck", generalized_lss_fpn(p["neck"], s["neck"])),
               **_prefix("depth_head", conv(p["depth_head"]))}
    else:
        out = {**_prefix("ddn_backbone", resnet_backbone(p["ddn_backbone"], s["ddn_backbone"])),
               **_prefix("ddn_classifier",
                         deeplab_classifier(p["ddn_classifier"], s["ddn_classifier"]))}
    return {**out, **_prefix("channel_reduce", conv_bn_relu(p["channel_reduce"],
                                                            s["channel_reduce"])),
            **_prefix("f2v", frustum_to_voxel(p["f2v"], s["f2v"])),
            **_prefix("backbone_3d", voxel_backbone(p["backbone_3d"], s["backbone_3d"])),
            **_prefix("fuser_conv", conv(p["fuser_conv"])),
            **_prefix("fuser_bn", batch_norm(p["fuser_bn"], s["fuser_bn"])),
            **_prefix("backbone_2d", conv_bn_layers(p["backbone_2d"], s["backbone_2d"])),
            **_prefix("dense_head", transfusion_head(p["dense_head"], s["dense_head"]))}


def from_jax_variables(variables):
    """JAX detector variables {"params", "batch_stats"} -> state_dict, for
    HGSFusionModel, RadarOnlyModel, PointPillarModel,
    PointPillarMultiHeadModel, BEVFusionModel, TransFusionModel,
    CenterPointModel, SECONDModel, VoxelRCNNModel, SECONDIoUModel,
    PVRCNNModel, PVRCNNPlusPlusModel, PartA2Model and VoxelNeXtModel (told apart by
    their top-level modules)."""
    p, s = variables["params"], variables["batch_stats"]
    if "fuser_conv" in p:
        return _bevfusion(p, s)
    if "backbone_3d" in p or "head" in p.get("dense_head", {}):
        return _backbone_families(p, s)
    if "decoder" in p.get("dense_head", {}):  # TransFusion-L
        return {**_prefix("pillar_net", pillar_feature_net(p["pillar_net"], s["pillar_net"])),
                **_prefix("backbone_2d", conv_bn_layers(p["backbone_2d"], s["backbone_2d"])),
                **_prefix("dense_head", transfusion_head(p["dense_head"], s["dense_head"]))}
    if "backbone_2d" in p:  # the PointPillar families
        head = p["dense_head"]
        return {**_prefix("pillar_net", pillar_feature_net(p["pillar_net"], s["pillar_net"])),
                **_prefix("backbone_2d", conv_bn_layers(p["backbone_2d"], s["backbone_2d"])),
                **_prefix("dense_head", anchor_head(head) if "conv_cls" in head
                          else anchor_head_multi(head, s.get("dense_head", {})))}
    if "ddn_backbone" not in p:  # the radar-only detector
        return {**_prefix("radar_backbone.reader",
                          pillar_feature_net(p["pillar_net"], s["pillar_net"])),
                **_prefix("radar_backbone",
                          pillar_net_radar(p["radar_backbone"], s["radar_backbone"])),
                **_prefix("dense_head", anchor_head(p["dense_head"]))}
    image = "fusion_vfe.image_vfe"
    out = _prefix(f"{image}.ffn.ddn.model.backbone",
                  resnet_backbone(p["ddn_backbone"], s["ddn_backbone"]))
    if "ddn_classifier" in p:  # USE_DEPTH
        out.update(_prefix(f"{image}.ffn.ddn.model.classifier",
                           deeplab_classifier(p["ddn_classifier"], s["ddn_classifier"])))
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
