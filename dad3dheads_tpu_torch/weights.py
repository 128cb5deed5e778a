"""Weights across the two packages: flax variables <-> the port's state dict,
a reader and writer of the JAX package's ``.msgpack`` predictor checkpoints,
and the reference's torch checkpoints in the port's keys.

The port's module tree uses the reference's torch state-dict keys, so the
bridge is the inverse of the explicit flax-path -> torch-key name maps of
``tools/port_torch_weights.py`` (``dad3dnet_name_map`` for both backbones,
``backbone_name_map`` for the ImageNet backbone-only dialects). ``tools/`` is
not a package, so :func:`name_map` and :func:`backbone_name_map` are copies
of those maps, and tests hold them equal. Layout conversions: conv HWIO <->
OIHW (a depthwise (k, k, 1, C) kernel <-> (C, 1, k, k)), dense (in, out) <->
(out, in), the BiFPN 1x1 depthwise scale (1, C) <-> (C, 1, 1, 1).

A flax tree or a state dict tells its backbone by its encoder's first
layer (:func:`flax_backbone`, :func:`state_dict_backbone`): a checkpoint of
one backbone refuses to load into a model of another, with an error that
names both.

The SwinV2 DAD-3DNet (``swinv2_b_w16``) has no counterpart in the JAX
package, so its ``.msgpack`` checkpoints, which the port writes and reads
(the trainer's export, ``FaceMeshPredictor``), hold its encoder under the
port's own flax-style names (:func:`_swin_encoder_entries`); the JAX
package's loaders cannot read them.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from .models.bifpn import BIFPN_NODES
from .models.layers import ConvBlock, MaskPredictionHead, MixSepConv, PixelShuffleUpsample, SepConv
from .models.mobilenet import MOBILENET_UNITS
from .models.resnet import RESNET50_UNITS
from .models.swin import SwinV2Stages, WindowAttention

NameMap = Dict[str, Tuple[str, str]]


def _path(*parts: str) -> str:
    """A '/'-joined flax path, empty parts left out."""
    return "/".join(p for p in parts if p)


def _conv_bn_entries(m: NameMap, fp: str, conv_key: str, bn_key: str, conv: str = "Conv_0",
                     bn: str = "BatchNorm_0") -> None:
    """A bias-free conv and its BN: flax ``fp/{conv,bn}`` -> torch keys."""
    m[_path("params", fp, conv, "kernel")] = (f"{conv_key}.weight", "conv")
    _bn_entries(m, fp, bn_key, bn)


def _bn_entries(m: NameMap, fp: str, tp: str, bn: str = "BatchNorm_0") -> None:
    m[_path("params", fp, bn, "scale")] = (f"{tp}.weight", "id")
    m[_path("params", fp, bn, "bias")] = (f"{tp}.bias", "id")
    m[_path("batch_stats", fp, bn, "mean")] = (f"{tp}.running_mean", "id")
    m[_path("batch_stats", fp, bn, "var")] = (f"{tp}.running_var", "id")


def _resnet50_encoder_entries(flax_prefix: str, torch_prefix: str) -> NameMap:
    """pytorchcv resnet50 feature extractor (``init_block.conv``,
    ``stage{S}.unit{U}.body.conv{1,2,3}``, ``unit1.identity_conv``)."""
    m: NameMap = {}
    _conv_bn_entries(m, f"{flax_prefix}/init_block/ConvBN_0", f"{torch_prefix}.init_block.conv.conv",
                     f"{torch_prefix}.init_block.conv.bn")
    for s, units in enumerate(RESNET50_UNITS, start=1):
        for u in range(units):
            fp, tp = f"{flax_prefix}/stage{s}/Bottleneck_{u}", f"{torch_prefix}.stage{s}.unit{u + 1}"
            for i in range(3):
                _conv_bn_entries(m, f"{fp}/ConvBN_{i}", f"{tp}.body.conv{i + 1}.conv", f"{tp}.body.conv{i + 1}.bn")
            if u == 0:  # the only unit with a projection shortcut
                _conv_bn_entries(m, f"{fp}/ConvBN_3", f"{tp}.identity_conv.conv", f"{tp}.identity_conv.bn")
    return m


def _torchvision_encoder_entries(flax_prefix: str) -> NameMap:
    """torchvision.models.resnet50 naming (``conv1``/``bn1``,
    ``layer{1-4}.{i}.conv{1-3}``/``bn{1-3}``, ``downsample.{0,1}``)."""
    m: NameMap = {}
    _conv_bn_entries(m, f"{flax_prefix}/init_block/ConvBN_0", "conv1", "bn1")
    for s, units in enumerate(RESNET50_UNITS, start=1):
        for u in range(units):
            fp, tp = f"{flax_prefix}/stage{s}/Bottleneck_{u}", f"layer{s}.{u}"
            for i in range(3):
                _conv_bn_entries(m, f"{fp}/ConvBN_{i}", f"{tp}.conv{i + 1}", f"{tp}.bn{i + 1}")
            if u == 0:
                _conv_bn_entries(m, f"{fp}/ConvBN_3", f"{tp}.downsample.0", f"{tp}.downsample.1")
    return m


def _mobilenet_encoder_entries(flax_prefix: str, torch_prefix: str) -> NameMap:
    """pytorchcv mobilenet_w1 feature extractor: flax ``init_conv``/``init_bn``
    then ``s{S}_{u}`` blocks with Conv_0/BatchNorm_0 (depthwise) and
    Conv_1/BatchNorm_1 (pointwise)."""
    m: NameMap = {f"params/{flax_prefix}/init_conv/kernel": (f"{torch_prefix}.init_block.conv.weight", "conv")}
    _bn_entries(m, flax_prefix, f"{torch_prefix}.init_block.bn", "init_bn")
    for s, units in enumerate(MOBILENET_UNITS, start=1):
        for u in range(units):
            fp, tp = f"{flax_prefix}/s{s}_{u}", f"{torch_prefix}.stage{s}.unit{u + 1}"
            _conv_bn_entries(m, fp, f"{tp}.dw_conv.conv", f"{tp}.dw_conv.bn")
            _conv_bn_entries(m, fp, f"{tp}.pw_conv.conv", f"{tp}.pw_conv.bn", "Conv_1", "BatchNorm_1")
    return m


def _swin_encoder_entries(flax_prefix: str, torch_prefix: str) -> NameMap:
    """The published SwinV2 encoder (``models/swin.py``) under the port's own
    flax-style names: each module's path with '/' for '.', then ``kernel``
    (a linear layer's (in, out), the patch conv's HWIO) and ``bias``, a
    LayerNorm's ``scale`` and ``bias``, and an attention's ``q_bias``,
    ``v_bias`` and ``logit_scale`` as they are."""
    with torch.device("meta"):
        encoder = SwinV2Stages()
    m: NameMap = {}
    for name, module in encoder.model.named_modules():
        fp, tp = _path("params", flax_prefix, name.replace(".", "/")), f"{torch_prefix}.{name}"
        if isinstance(module, (torch.nn.Linear, torch.nn.Conv2d)):
            m[f"{fp}/kernel"] = (f"{tp}.weight", "dense" if isinstance(module, torch.nn.Linear) else "conv")
            if module.bias is not None:
                m[f"{fp}/bias"] = (f"{tp}.bias", "id")
        elif isinstance(module, torch.nn.LayerNorm):
            m[f"{fp}/scale"] = (f"{tp}.weight", "id")
            m[f"{fp}/bias"] = (f"{tp}.bias", "id")
        elif isinstance(module, WindowAttention):
            for leaf in ("q_bias", "v_bias", "logit_scale"):
                m[f"{fp}/{leaf}"] = (f"{tp}.{leaf}", "id")
    return m


def name_map(backbone: str = "resnet50") -> NameMap:
    """flax path ('/'-joined, collection first) -> (torch state-dict key,
    layout kind) for the DAD-3DNet of ``backbone``."""
    if backbone == "resnet50":
        m = _resnet50_encoder_entries("encoder", "encoder.model")
    elif backbone == "mobilenet_w1":
        m = _mobilenet_encoder_entries("encoder", "encoder.model")
    elif backbone == "swinv2_b_w16":
        m = _swin_encoder_entries("encoder", "encoder.model")
    else:
        raise KeyError(f"unknown backbone {backbone!r}: resnet50, mobilenet_w1 or swinv2_b_w16")

    for p in ("p3", "p4", "p5", "p6"):
        m[f"params/bifpn/{p}/kernel"] = (f"bifpn.{p}.weight", "conv")
        m[f"params/bifpn/{p}/bias"] = (f"bifpn.{p}.bias", "id")
    m["params/bifpn/p7/Conv_0/kernel"] = ("bifpn.p7.conv.weight", "conv")
    m["params/bifpn/p7/Conv_0/bias"] = ("bifpn.p7.conv.bias", "id")
    _bn_entries(m, "bifpn/p7", "bifpn.p7.bn")
    for k in range(2):
        m[f"params/bifpn/block{k}/w1"] = (f"bifpn.bifpn.{k}.w1", "id")
        m[f"params/bifpn/block{k}/w2"] = (f"bifpn.bifpn.{k}.w2", "id")
        for node in BIFPN_NODES:
            fp, tp = f"bifpn/block{k}/{node}", f"bifpn.bifpn.{k}.{node}"
            m[f"params/{fp}/depthwise_scale"] = (f"{tp}.depthwise.weight", "dw")
            _conv_bn_entries(m, fp, f"{tp}.pointwise", f"{tp}.bn")

    m["params/heatmap_head/kernel"] = ("head.heatmap.weight", "conv")
    m["params/heatmap_head/bias"] = ("head.heatmap.bias", "id")
    m["params/fusion/Conv_0/kernel"] = ("fusion_layer.conv1x1.weight", "conv")
    m["params/fusion/Conv_0/bias"] = ("fusion_layer.conv1x1.bias", "id")
    for fh, th in (("shape_head", "shape"), ("pose_head", "pose"), ("landmarks_head", "landmarks")):
        for fd, td in (("Dense_0", "0"), ("Dense_1", "3")):
            m[f"params/{fh}/{fd}/kernel"] = (f"{th}.logit_image.{td}.weight", "dense")
            m[f"params/{fh}/{fd}/bias"] = (f"{th}.logit_image.{td}.bias", "id")
    return m


def backbone_name_map(dialect: str) -> NameMap:
    """flax path -> (source key, kind) for an ImageNet-pretrained resnet50
    backbone alone: ``pytorchcv`` (a full pytorchcv model's ``features.*``
    keys) or ``torchvision`` (torchvision.models.resnet50 naming)."""
    if dialect == "pytorchcv":
        return _resnet50_encoder_entries("encoder", "features")
    if dialect == "torchvision":
        return _torchvision_encoder_entries("encoder")
    raise KeyError(f"unknown backbone dialect {dialect!r}")


def _to_torch_layout(value: np.ndarray, kind: str) -> np.ndarray:
    if kind == "conv":  # HWIO -> OIHW
        return np.transpose(value, (3, 2, 0, 1))
    if kind == "dense":  # (in, out) -> (out, in)
        return value.T
    if kind == "dw":  # per-channel scale (1, C) -> depthwise 1x1 (C, 1, 1, 1)
        return value.reshape(-1, 1, 1, 1)
    return value


def _to_flax_layout(value: np.ndarray, kind: str) -> np.ndarray:
    if kind == "conv":  # OIHW -> HWIO
        return np.transpose(value, (2, 3, 1, 0))
    if kind == "dense":
        return value.T
    if kind == "dw":
        return value.reshape(1, -1)
    return value


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flatten(dict(v.items()), path))
        else:
            out[path] = v
    return out


def flax_backbone(variables: Mapping[str, Any]) -> str:
    """The backbone of a flax DAD-3DNet tree, from its encoder's first layer."""
    encoder = variables.get("params", {}).get("encoder", {})
    if "init_conv" in encoder:
        return "mobilenet_w1"
    if "init_block" in encoder:
        return "resnet50"
    if "patch_embed" in encoder:
        return "swinv2_b_w16"
    raise KeyError("flax tree has no encoder of a known backbone (params/encoder/init_conv, init_block or "
                   "patch_embed)")


def state_dict_backbone(state_dict: Mapping[str, Any]) -> str:
    """The backbone of a port (or reference) DAD-3DNet state dict."""
    if "encoder.model.init_block.bn.weight" in state_dict:
        return "mobilenet_w1"
    if "encoder.model.init_block.conv.bn.weight" in state_dict:
        return "resnet50"
    if "encoder.model.patch_embed.proj.weight" in state_dict:
        return "swinv2_b_w16"
    raise KeyError("state dict has no encoder of a known backbone (encoder.model.init_block.* or "
                   "encoder.model.patch_embed.*)")


def _check_backbone(found: str, model: torch.nn.Module, what: str) -> None:
    """Raise if weights of backbone ``found`` are headed for a model of
    another backbone."""
    expected = model.backbone
    if found != expected:
        raise ValueError(
            f"{what} holds a {found} DAD-3DNet, but the model is {expected}: set the model "
            f"config's backbone to {found!r}, or load a {expected} checkpoint"
        )


def _state_dict_by_map(flat: Dict[str, Any], m: NameMap) -> Dict[str, torch.Tensor]:
    """flat flax leaves -> torch tensors under ``m``; raises unless the leaves
    and the map's paths are the same set."""
    unknown = sorted(set(flat) - set(m))
    missing = sorted(set(m) - set(flat))
    if unknown or missing:
        raise KeyError(f"flax tree does not match the map: unknown {unknown[:5]}, missing {missing[:5]}")
    sd: Dict[str, torch.Tensor] = {}
    for path, (key, kind) in m.items():
        value = np.asarray(flat[path], dtype=np.float32)
        sd[key] = torch.tensor(np.ascontiguousarray(_to_torch_layout(value, kind)))
        if key.endswith(".running_var"):  # BN counters have no flax leaf
            sd[key[: -len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    return sd


def state_dict_from_flax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """flax ``{"params": ..., "batch_stats": ...}`` (nested dicts of arrays)
    of either backbone (:func:`flax_backbone`) -> the port's state dict,
    ready for ``load_state_dict(strict=True)``.

    Raises if a flax leaf has no entry in the map or a map entry has no leaf."""
    return _state_dict_by_map(_flatten(variables), name_map(flax_backbone(variables)))


def flax_from_state_dict(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse: the port's state dict, of either backbone, -> nested flax
    variables of numpy arrays. ``num_batches_tracked`` has no flax
    counterpart and is dropped."""
    variables: Dict[str, Any] = {}
    for path, (key, kind) in name_map(state_dict_backbone(state_dict)).items():
        value = state_dict[key].detach().cpu().float().numpy()
        node = variables
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(_to_flax_layout(value, kind))
    return variables


def layer_name_map(module: torch.nn.Module) -> NameMap:
    """flax path -> (torch key, kind) for one module of the layer zoo
    (``models/layers.py``), under flax's auto-names: ``Conv_i`` and
    ``BatchNorm_i`` in creation order inside a block, ``SepConv_i`` (etc.)
    for a head's blocks."""
    m: NameMap = {}
    if isinstance(module, ConvBlock):
        _conv_bn_entries(m, "", "conv", "bn")
    elif isinstance(module, SepConv):
        _conv_bn_entries(m, "", "dw_conv.conv", "dw_conv.bn")
        _conv_bn_entries(m, "", "pw_conv.conv", "pw_conv.bn", "Conv_1", "BatchNorm_1")
    elif isinstance(module, MixSepConv):
        n = len(module.dw_convs)
        for i in range(n):
            m[f"params/Conv_{i}/kernel"] = (f"dw_convs.{i}.weight", "conv")
        _conv_bn_entries(m, "", "pw_conv.conv", "pw_conv.bn", f"Conv_{n}")
    elif isinstance(module, PixelShuffleUpsample):
        m["params/Conv_0/kernel"] = ("conv.weight", "conv")
        m["params/Conv_0/bias"] = ("conv.bias", "id")
    elif isinstance(module, MaskPredictionHead):
        for i, block in enumerate(module.blocks):
            name = f"{type(block).__name__}_{i}"
            for path, (key, kind) in layer_name_map(block).items():
                collection, rest = path.split("/", 1)
                m[_path(collection, name, rest)] = (f"blocks.{i}.{key}", kind)
        m["params/Conv_0/kernel"] = ("logit.weight", "conv")
        m["params/Conv_0/bias"] = ("logit.bias", "id")
    else:
        raise TypeError(f"no flax name map for {type(module).__name__}")
    return m


def layer_state_dict_from_flax(module: torch.nn.Module, variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """flax variables of a layer-zoo module -> its state dict (strict)."""
    return _state_dict_by_map(_flatten(variables), layer_name_map(module))


def state_dict_from_reference(state_dict: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A reference DAD-3DNet checkpoint's tensors (a TorchScript module's
    state dict, or a Lightning checkpoint's ``state_dict`` with its
    ``model.`` prefix) -> the port's state dict, for either backbone. The
    port's keys are the reference's, so this strips the prefix and holds the
    keys to the backbone's map: raises on a missing or an unknown tensor."""
    sd = {k[len("model."):] if k.startswith("model.") else k: v for k, v in state_dict.items()}
    m = name_map(state_dict_backbone(sd))
    wanted = {key for key, _ in m.values()}
    tensors = {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    missing, unknown = sorted(wanted - set(tensors)), sorted(set(tensors) - wanted)
    if missing or unknown:
        raise KeyError(f"reference checkpoint does not match the map: unknown {unknown[:5]}, missing {missing[:5]}")
    out = {k: torch.as_tensor(v) for k, v in tensors.items()}
    for key in wanted:
        if key.endswith(".running_var"):
            out[key[: -len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    return out


def state_dict_from_backbone(state_dict: Mapping[str, Any], dialect: str) -> Dict[str, torch.Tensor]:
    """An ImageNet-pretrained resnet50's tensors in the ``pytorchcv`` or
    ``torchvision`` naming -> the port's encoder keys (``encoder.model.*``),
    for ``load_state_dict(strict=False)`` into a resnet50 DAD-3DNet (the rest
    keeps its initialisation). The classifier (``output.*`` / ``fc.*``) is
    dropped; raises on any other tensor the map does not consume, or a
    missing one."""
    port = name_map("resnet50")
    source = backbone_name_map(dialect)
    by_source = {src: port[path][0] for path, (src, _) in source.items()}
    tensors = {k: v for k, v in state_dict.items()
               if not k.endswith("num_batches_tracked") and not k.startswith(("output.", "fc."))}
    missing, unknown = sorted(set(by_source) - set(tensors)), sorted(set(tensors) - set(by_source))
    if missing or unknown:
        raise KeyError(f"{dialect} backbone does not match the map: unknown {unknown[:5]}, missing {missing[:5]}")
    return {by_source[k]: torch.as_tensor(v) for k, v in tensors.items()}


def _bf16_to_f32(buffer: bytes) -> np.ndarray:
    """bfloat16 bits are the upper half of float32's."""
    return (np.frombuffer(buffer, np.uint16).astype(np.uint32) << 16).view(np.float32)


def _ndarray_from_ext(data: bytes) -> np.ndarray:
    """flax's ndarray msgpack ext payload: packed (shape, dtype name, bytes)."""
    import msgpack

    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    if dtype_name == b"bfloat16":
        arr = _bf16_to_f32(buffer)
    else:
        arr = np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode()))
    return arr.reshape(shape)


def load_flax_msgpack(path: str) -> Dict[str, Any]:
    """Read a checkpoint written by the JAX package's
    ``save_predictor_checkpoint`` (flax ``serialization.to_bytes``) into
    nested dicts of numpy arrays, without flax or jax."""
    try:
        import msgpack
    except ImportError as e:
        raise ImportError(
            "reading flax .msgpack checkpoints needs the 'msgpack' package"
        ) from e

    ext_ndarray, ext_npscalar = 1, 3  # flax's _MsgpackExtType codes

    def ext_hook(code: int, data: bytes):
        if code == ext_ndarray:
            return _ndarray_from_ext(data)
        if code == ext_npscalar:
            return _ndarray_from_ext(data)[()]
        return msgpack.ExtType(code, data)

    with open(path, "rb") as f:
        return msgpack.unpackb(f.read(), ext_hook=ext_hook, raw=False)


def load_checkpoint(model: torch.nn.Module, path: str) -> None:
    """Load a JAX-package ``.msgpack`` predictor checkpoint into ``model``;
    raises if it holds the other backbone's network."""
    variables = load_flax_msgpack(path)
    _check_backbone(flax_backbone(variables), model, f"checkpoint {path}")
    model.load_state_dict(state_dict_from_flax(variables), strict=True)


def _ndarray_to_ext(arr: np.ndarray) -> bytes:
    """flax's ndarray msgpack ext payload (the inverse of _ndarray_from_ext)."""
    import msgpack

    arr = np.ascontiguousarray(arr)
    return msgpack.packb((arr.shape, arr.dtype.name, arr.tobytes("C")), use_bin_type=True)


def save_flax_msgpack(variables: Dict[str, Any], path: str) -> str:
    """Write nested dicts of numpy arrays as flax's ``serialization.to_bytes``
    does, so that the JAX package's loaders (``serialization.from_bytes``)
    and :func:`load_flax_msgpack` both read the file."""
    import msgpack

    ext_ndarray = 1  # flax's _MsgpackExtType.ndarray

    def default(x):
        if isinstance(x, np.ndarray):
            return msgpack.ExtType(ext_ndarray, _ndarray_to_ext(x))
        raise TypeError(f"cannot serialize {type(x)}")

    data = msgpack.packb(variables, default=default, strict_types=True)
    with open(path, "wb") as f:
        f.write(data)
    return path


# -- training state ----------------------------------------------------------
# optax's Adam keeps ``mu``/``nu`` trees shaped like ``params`` and one
# ``count``; torch.optim.Adam keeps, per parameter in ``model.parameters()``
# order, ``exp_avg``/``exp_avg_sq`` in the parameter's own layout and a
# float ``step``. Same update: mu / (1 - b1^t) / (sqrt(nu / (1 - b2^t)) + eps).
# optax.lamb starts its chain with the same ``ScaleByAdamState`` (the weight
# decay and the trust ratio keep no state), and the port's ``Lamb`` keeps
# Adam's keys: one bridge serves both.


def adam_moments(opt_state: Any) -> Dict[str, Any]:
    """The one ``ScaleByAdamState`` inside an optax state (Adam's or lamb's,
    behind a clip or not) -> {"mu", "nu", "count"} as numpy. Found by its
    fields, so that flax and optax need not be imported."""
    found = []

    def walk(node):
        if isinstance(node, tuple) and getattr(node, "_fields", None) is not None:
            if {"count", "mu", "nu"} <= set(node._fields):
                found.append(node)
                return
            for child in node:
                walk(child)
        elif isinstance(node, (tuple, list)):
            for child in node:
                walk(child)
        elif isinstance(node, Mapping):
            for child in node.values():
                walk(child)

    def as_np(tree):
        return {k: as_np(v) for k, v in tree.items()} if isinstance(tree, Mapping) else np.array(tree)

    walk(opt_state)
    if len(found) != 1:
        raise ValueError(f"expected one ScaleByAdamState in the optimizer state, found {len(found)}")
    (adam,) = found
    return {"mu": as_np(adam.mu), "nu": as_np(adam.nu), "count": int(np.asarray(adam.count))}


def _param_paths(model: torch.nn.Module) -> list:
    """(flax path under ``params/``, layout kind) of each parameter, in
    ``model.parameters()`` order."""
    m = name_map(model.backbone)
    by_key = {key: (path, kind) for path, (key, kind) in m.items() if path.startswith("params/")}
    return [by_key[name] for name, _ in model.named_parameters()]


def adam_state_from_flax(mu: Dict[str, Any], nu: Dict[str, Any], count, model: torch.nn.Module) -> Dict[int, Dict[str, torch.Tensor]]:
    """optax ``ScaleByAdamState`` (mu, nu: trees like ``params``; count) ->
    the ``state`` part of a ``torch.optim.Adam`` (or ``train.optimizers.Lamb``)
    state dict for ``model``."""
    flat_mu, flat_nu = _flatten({"params": mu}), _flatten({"params": nu})
    step = torch.tensor(float(np.asarray(count)))
    state = {}
    for i, (path, kind) in enumerate(_param_paths(model)):
        state[i] = {
            "step": step.clone(),
            "exp_avg": torch.tensor(np.ascontiguousarray(_to_torch_layout(np.asarray(flat_mu[path], np.float32), kind))),
            "exp_avg_sq": torch.tensor(np.ascontiguousarray(_to_torch_layout(np.asarray(flat_nu[path], np.float32), kind))),
        }
    return state


def flax_adam_state_from_port(state: Dict[int, Dict[str, torch.Tensor]], model: torch.nn.Module) -> Dict[str, Any]:
    """The inverse: a ``torch.optim.Adam`` or ``Lamb`` state (by parameter
    index) -> {"mu": tree, "nu": tree, "count": int} in the layout of flax
    ``params``."""
    out: Dict[str, Any] = {"mu": {}, "nu": {}}
    count = 0
    for i, (path, kind) in enumerate(_param_paths(model)):
        count = int(state[i]["step"])
        for name, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            node = out[name]
            *parents, leaf = path.split("/")[1:]
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = np.ascontiguousarray(_to_flax_layout(state[i][key].detach().cpu().numpy(), kind))
    out["count"] = count
    return out


def train_state_from_flax(
    variables: Dict[str, Any], adam: Any, model: torch.nn.Module, optimizer: torch.optim.Optimizer
) -> None:
    """Load the JAX package's train state, as numpy trees, into the port:
    ``variables`` {"params", "batch_stats"} into ``model``, and ``adam`` into
    ``optimizer``, a ``torch.optim.Adam`` or the port's ``Lamb`` over
    ``model.parameters()``. ``adam`` is {"mu", "nu", "count"} or the optax
    state that holds them (adam's or lamb's chain, behind a clip or not;
    see :func:`adam_moments`). Raises if the state is the other backbone's."""
    _check_backbone(flax_backbone(variables), model, "train state")
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    if not (isinstance(adam, dict) and {"mu", "nu", "count"} <= set(adam)):
        adam = adam_moments(adam)
    state = adam_state_from_flax(adam["mu"], adam["nu"], adam["count"], model)
    # load_state_dict moves the moments to each parameter's device
    optimizer.load_state_dict({"state": state, "param_groups": optimizer.state_dict()["param_groups"]})
