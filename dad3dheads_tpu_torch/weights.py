"""Weights across the two packages: flax variables <-> the port's state dict,
and a reader for the JAX package's ``.msgpack`` predictor checkpoints.

The port's module tree uses the reference's torch state-dict keys, so the
bridge is the inverse of the explicit flax-path -> torch-key name map of
``tools/port_torch_weights.py`` (``dad3dnet_resnet50_name_map``). ``tools/``
is not a package, so :func:`name_map` is a copy of that map, and a test holds
the two equal. Layout conversions: conv HWIO <-> OIHW, dense (in, out) <->
(out, in), the BiFPN 1x1 depthwise scale (1, C) <-> (C, 1, 1, 1).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

RESNET50_STAGE_UNITS = (3, 4, 6, 3)
BIFPN_NODES = ("p3_td", "p4_td", "p5_td", "p6_td", "p4_out", "p5_out", "p6_out", "p7_out")


def name_map() -> Dict[str, Tuple[str, str]]:
    """flax path ('/'-joined, collection first) -> (torch state-dict key,
    layout kind) for the resnet50 DAD-3DNet."""
    m: Dict[str, Tuple[str, str]] = {}

    def conv_bn(fp: str, tp: str) -> None:
        m[f"params/{fp}/Conv_0/kernel"] = (f"{tp}.conv.weight", "conv")
        m[f"params/{fp}/BatchNorm_0/scale"] = (f"{tp}.bn.weight", "id")
        m[f"params/{fp}/BatchNorm_0/bias"] = (f"{tp}.bn.bias", "id")
        m[f"batch_stats/{fp}/BatchNorm_0/mean"] = (f"{tp}.bn.running_mean", "id")
        m[f"batch_stats/{fp}/BatchNorm_0/var"] = (f"{tp}.bn.running_var", "id")

    conv_bn("encoder/init_block/ConvBN_0", "encoder.model.init_block.conv")
    for s, units in enumerate(RESNET50_STAGE_UNITS, start=1):
        for u in range(units):
            fp = f"encoder/stage{s}/Bottleneck_{u}"
            tp = f"encoder.model.stage{s}.unit{u + 1}"
            for i in range(3):
                conv_bn(f"{fp}/ConvBN_{i}", f"{tp}.body.conv{i + 1}")
            if u == 0:  # the only unit with a projection shortcut
                conv_bn(f"{fp}/ConvBN_3", f"{tp}.identity_conv")

    def bn(fp: str, tp: str) -> None:
        m[f"params/{fp}/BatchNorm_0/scale"] = (f"{tp}.weight", "id")
        m[f"params/{fp}/BatchNorm_0/bias"] = (f"{tp}.bias", "id")
        m[f"batch_stats/{fp}/BatchNorm_0/mean"] = (f"{tp}.running_mean", "id")
        m[f"batch_stats/{fp}/BatchNorm_0/var"] = (f"{tp}.running_var", "id")

    for p in ("p3", "p4", "p5", "p6"):
        m[f"params/bifpn/{p}/kernel"] = (f"bifpn.{p}.weight", "conv")
        m[f"params/bifpn/{p}/bias"] = (f"bifpn.{p}.bias", "id")
    m["params/bifpn/p7/Conv_0/kernel"] = ("bifpn.p7.conv.weight", "conv")
    m["params/bifpn/p7/Conv_0/bias"] = ("bifpn.p7.conv.bias", "id")
    bn("bifpn/p7", "bifpn.p7.bn")
    for k in range(2):
        m[f"params/bifpn/block{k}/w1"] = (f"bifpn.bifpn.{k}.w1", "id")
        m[f"params/bifpn/block{k}/w2"] = (f"bifpn.bifpn.{k}.w2", "id")
        for node in BIFPN_NODES:
            fp, tp = f"bifpn/block{k}/{node}", f"bifpn.bifpn.{k}.{node}"
            m[f"params/{fp}/depthwise_scale"] = (f"{tp}.depthwise.weight", "dw")
            m[f"params/{fp}/Conv_0/kernel"] = (f"{tp}.pointwise.weight", "conv")
            bn(fp, f"{tp}.bn")

    m["params/heatmap_head/kernel"] = ("head.heatmap.weight", "conv")
    m["params/heatmap_head/bias"] = ("head.heatmap.bias", "id")
    m["params/fusion/Conv_0/kernel"] = ("fusion_layer.conv1x1.weight", "conv")
    m["params/fusion/Conv_0/bias"] = ("fusion_layer.conv1x1.bias", "id")
    for fh, th in (("shape_head", "shape"), ("pose_head", "pose"), ("landmarks_head", "landmarks")):
        for fd, td in (("Dense_0", "0"), ("Dense_1", "3")):
            m[f"params/{fh}/{fd}/kernel"] = (f"{th}.logit_image.{td}.weight", "dense")
            m[f"params/{fh}/{fd}/bias"] = (f"{th}.logit_image.{td}.bias", "id")
    return m


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


def state_dict_from_flax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """flax ``{"params": ..., "batch_stats": ...}`` (nested dicts of arrays)
    -> the port's state dict, ready for ``load_state_dict(strict=True)``.

    Raises if a flax leaf has no entry in the map or a map entry has no leaf."""
    flat = _flatten(variables)
    m = name_map()
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


def flax_from_state_dict(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse: the port's state dict -> nested flax variables of numpy
    arrays. ``num_batches_tracked`` has no flax counterpart and is dropped."""
    variables: Dict[str, Any] = {}
    for path, (key, kind) in name_map().items():
        value = state_dict[key].detach().cpu().float().numpy()
        node = variables
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(_to_flax_layout(value, kind))
    return variables


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
    """Load a JAX-package ``.msgpack`` predictor checkpoint into ``model``."""
    model.load_state_dict(state_dict_from_flax(load_flax_msgpack(path)), strict=True)


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


def _param_paths(model: torch.nn.Module) -> list:
    """(flax path under ``params/``, layout kind) of each parameter, in
    ``model.parameters()`` order."""
    by_key = {key: (path, kind) for path, (key, kind) in name_map().items() if path.startswith("params/")}
    return [by_key[name] for name, _ in model.named_parameters()]


def adam_state_from_flax(mu: Dict[str, Any], nu: Dict[str, Any], count, model: torch.nn.Module) -> Dict[int, Dict[str, torch.Tensor]]:
    """optax ``ScaleByAdamState`` (mu, nu: trees like ``params``; count) ->
    the ``state`` part of a ``torch.optim.Adam`` state dict for ``model``."""
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
    """The inverse: a ``torch.optim.Adam`` state (by parameter index) ->
    {"mu": tree, "nu": tree, "count": int} in the layout of flax ``params``."""
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
    variables: Dict[str, Any], adam: Dict[str, Any], model: torch.nn.Module, optimizer: torch.optim.Optimizer
) -> None:
    """Load the JAX package's train state, as numpy trees, into the port:
    ``variables`` {"params", "batch_stats"} into ``model``, and ``adam``
    {"mu", "nu", "count"} (the ``ScaleByAdamState`` inside its
    clip_by_global_norm chain) into ``optimizer``, a ``torch.optim.Adam``
    over ``model.parameters()``."""
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    state = adam_state_from_flax(adam["mu"], adam["nu"], adam["count"], model)
    # load_state_dict moves the moments to each parameter's device
    optimizer.load_state_dict({"state": state, "param_groups": optimizer.state_dict()["param_groups"]})
