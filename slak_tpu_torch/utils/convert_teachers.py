"""Teacher checkpoints for the port's KD zoo (``models/vit.py``,
``swin.py``, ``cswin.py``, ``resnet.py``, ``mobile.py``).

The port's teachers carry timm's parameter names, exactly those that
``slak_tpu/utils/convert_teachers.py`` reads, so:

  * :func:`load_teacher_checkpoint` loads a timm ``.pth`` straight into a
    port teacher (the state dict unwrapped from ``model`` /
    ``state_dict`` / ``model_ema`` and stripped of ``module.``, as
    ``_unwrap`` does; timm's recomputed buffers, the Swin relative index
    and attention mask, dropped);
  * :func:`teacher_from_jax` builds a port teacher from a JAX teacher's
    parameters (and BN state), the inverse of each ``convert_*_state_dict``
    there: HWIO -> OIHW convs, (in, out) -> (out, in) linears, Swin's
    patch-merge parameters permuted back to timm's concatenation order
    (the permutation swaps the middle two of four groups: its own
    inverse), CSWin's one LePE tensor split into the block's convs;
  * :func:`kd_params_from_jax` does the same for the KD heads
    (``fd_proj``, the MGD convs).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from slak_tpu_torch.models import zoo

# buffers timm keeps in its state dicts that the port recomputes
_RECOMPUTED = ("relative_position_index", "attn_mask")


def _unwrap(sd: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    for key in ("model", "state_dict", "model_ema"):
        if key in sd and isinstance(sd[key], dict):
            sd = sd[key]
            break
    out = {}
    for k, v in sd.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if k.rsplit(".", 1)[-1] in _RECOMPUTED:
            continue
        out[k] = torch.as_tensor(v)
    return out


def load_teacher_checkpoint(path: str, name: str, device=None,
                            **kw) -> zoo.Teacher:
    """The zoo teacher ``name`` with the weights of the timm checkpoint at
    ``path``, in eval mode on ``device`` (CUDA unless the CPU is asked
    for). ``kw``: config keywords of the constructor (``num_classes``
    defaults to the checkpoint's classifier rows)."""
    if zoo.family_of(name) is None:
        raise ValueError(f"no teacher converter for {name!r}")
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if not isinstance(ckpt, dict):
        raise ValueError(f"unsupported checkpoint object in {path}")
    sd = _unwrap(ckpt)
    if "num_classes" not in kw:
        kw["num_classes"] = next(sd[k].shape[0] for k in (
            "head.weight", "fc.weight", "classifier.weight") if k in sd)
    model = zoo.registry()[name](**kw)
    model.load_state_dict(sd)
    return model.to(zoo.resolve_device(device)).eval()


# --- JAX parameters -> the port's state dicts ---------------------------------


def _t(v) -> torch.Tensor:
    return torch.from_numpy(np.array(v, dtype=np.float32))


def _oihw(w) -> torch.Tensor:
    return _t(np.asarray(w).transpose(3, 2, 0, 1))


def _lin(sd, prefix, p):
    sd[prefix + ".weight"] = _t(np.asarray(p["w"]).T)
    if "b" in p:
        sd[prefix + ".bias"] = _t(p["b"])


def _conv(sd, prefix, p):
    sd[prefix + ".weight"] = _oihw(p["w"])
    if "b" in p:
        sd[prefix + ".bias"] = _t(p["b"])


def _ln(sd, prefix, p):
    sd[prefix + ".weight"] = _t(p["scale"])
    sd[prefix + ".bias"] = _t(p["bias"])


def _bn(sd, prefix, p, s):
    _ln(sd, prefix, p)
    sd[prefix + ".running_mean"] = _t(s["mean"])
    sd[prefix + ".running_var"] = _t(s["var"])


def _merge_perm(v, c: int, axis: int = 0):
    """Swap the middle two of the four c-wide groups along ``axis``
    (timm's patch-merge order <-> the JAX package's)."""
    idx = np.concatenate([np.arange(c), 2 * c + np.arange(c),
                          c + np.arange(c), 3 * c + np.arange(c)])
    return np.take(np.asarray(v), idx, axis=axis)


def _vit_sd(p, s, model) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    _conv(sd, "patch_embed.proj", p["patch_embed"])
    sd["cls_token"] = _t(p["cls_token"])
    sd["pos_embed"] = _t(p["pos_embed"])
    for i, b in enumerate(p["blocks"]):
        pre = f"blocks.{i}"
        _ln(sd, pre + ".norm1", b["norm1"])
        _lin(sd, pre + ".attn.qkv", b["qkv"])
        _lin(sd, pre + ".attn.proj", b["proj"])
        _ln(sd, pre + ".norm2", b["norm2"])
        _lin(sd, pre + ".mlp.fc1", b["fc1"])
        _lin(sd, pre + ".mlp.fc2", b["fc2"])
    _ln(sd, "norm", p["norm"])
    _lin(sd, "head", p["head"])
    return sd


def _swin_sd(p, s, model) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    _conv(sd, "patch_embed.proj", p["patch_embed"])
    _ln(sd, "patch_embed.norm", p["embed_norm"])
    for i, blocks in enumerate(p["stages"]):
        for j, b in enumerate(blocks):
            pre = f"layers.{i}.blocks.{j}"
            _ln(sd, pre + ".norm1", b["norm1"])
            _lin(sd, pre + ".attn.qkv", b["qkv"])
            _lin(sd, pre + ".attn.proj", b["proj"])
            sd[pre + ".attn.relative_position_bias_table"] = _t(
                b["rel_bias"])
            _ln(sd, pre + ".norm2", b["norm2"])
            _lin(sd, pre + ".mlp.fc1", b["fc1"])
            _lin(sd, pre + ".mlp.fc2", b["fc2"])
        if i < len(p["merge"]):
            m = p["merge"][i]
            c = np.asarray(m["norm"]["scale"]).shape[0] // 4
            pre = f"layers.{i}.downsample"
            sd[pre + ".norm.weight"] = _t(_merge_perm(m["norm"]["scale"], c))
            sd[pre + ".norm.bias"] = _t(_merge_perm(m["norm"]["bias"], c))
            sd[pre + ".reduction.weight"] = _t(
                _merge_perm(m["reduction"]["w"], c, axis=0).T)
    _ln(sd, "norm", p["norm"])
    _lin(sd, "head", p["head"])
    return sd


def _cswin_sd(p, s, model) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    _conv(sd, "stage1_conv_embed.0", p["embed"])
    _ln(sd, "stage1_conv_embed.2", p["embed_norm"])
    for i, blocks in enumerate(p["stages"]):
        for j, b in enumerate(blocks):
            pre = f"stage{i + 1}.{j}"
            _ln(sd, pre + ".norm1", b["norm1"])
            _lin(sd, pre + ".qkv", b["qkv"])
            _lin(sd, pre + ".proj", b["proj"])
            _ln(sd, pre + ".norm2", b["norm2"])
            _lin(sd, pre + ".mlp.fc1", b["fc1"])
            _lin(sd, pre + ".mlp.fc2", b["fc2"])
            w = np.asarray(b["lepe"]["w"]).transpose(2, 0, 1)[:, None]
            bias = np.asarray(b["lepe"]["b"])
            n = len(getattr(model, f"stage{i + 1}")[j].attns)
            for k, (wk, bk) in enumerate(zip(np.split(w, n), np.split(bias,
                                                                      n))):
                sd[f"{pre}.attns.{k}.get_v.weight"] = _t(wk)
                sd[f"{pre}.attns.{k}.get_v.bias"] = _t(bk)
        if i < len(p["merge"]):
            _conv(sd, f"merge{i + 1}.conv", p["merge"][i]["conv"])
            _ln(sd, f"merge{i + 1}.norm", p["merge"][i]["norm"])
    _ln(sd, "norm", p["norm"])
    _lin(sd, "head", p["head"])
    return sd


def _resnet_sd(p, s, model) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    for (ck, bk), sp, ss in zip((("conv1.0", "conv1.1"),
                                 ("conv1.3", "conv1.4"), ("conv1.6", "bn1")),
                                p["stem"], s["stem"]):
        _conv(sd, ck, sp["conv"])
        _bn(sd, bk, sp["bn"], ss["bn"])
    for i, (bps, bss) in enumerate(zip(p["stages"], s["stages"])):
        for j, (bp, bs) in enumerate(zip(bps, bss)):
            pre = f"layer{i + 1}.{j}"
            for c in ("conv1", "conv2", "conv3"):
                _conv(sd, f"{pre}.{c}", bp[c])
                _bn(sd, f"{pre}.bn{c[-1]}", bp[c + "_bn"], bs[c + "_bn"])
            if "down" in bp:
                _conv(sd, pre + ".downsample.1", bp["down"])
                _bn(sd, pre + ".downsample.2", bp["down_bn"], bs["down_bn"])
    _lin(sd, "fc", p["head"])
    return sd


def _mobile_sd(p, s, model) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    _conv(sd, "conv_stem", p["stem"])
    _bn(sd, "bn1", p["stem_bn"], s["stem_bn"])
    names = [f"blocks.{si}.{bi}" for si, st in enumerate(model.blocks)
             for bi in range(len(st))]
    for pre, bp, bs in zip(names, p["blocks"], s["blocks"]):
        if "expand" in bp:
            slots = (("conv_pw", "bn1", "expand"), ("conv_dw", "bn2", "dw"),
                     ("conv_pwl", "bn3", "project"))
        else:
            slots = (("conv_dw", "bn1", "dw"), ("conv_pw", "bn2", "project"))
        for ck, bk, key in slots:
            _conv(sd, f"{pre}.{ck}", bp[key])
            _bn(sd, f"{pre}.{bk}", bp[key + "_bn"], bs[key + "_bn"])
        if "se_reduce" in bp:
            _conv(sd, pre + ".se.conv_reduce", bp["se_reduce"])
            _conv(sd, pre + ".se.conv_expand", bp["se_expand"])
    _conv(sd, "conv_head", p["head_conv"])
    if "head_bn" in p:
        _bn(sd, "bn2", p["head_bn"], s["head_bn"])
    _lin(sd, "classifier", p["classifier"])
    return sd


# the port state dict of a zoo teacher holding a JAX teacher's (params,
# BN state), by family
_FAMILY_SD = {"vit": _vit_sd, "swin": _swin_sd, "cswin": _cswin_sd,
              "resnet": _resnet_sd, "mobile": _mobile_sd}


def teacher_from_jax(name: str, params: Dict[str, Any],
                     state: Optional[Dict[str, Any]] = None, device=None,
                     **kw) -> zoo.Teacher:
    """The zoo teacher ``name`` (config keywords ``kw``, as the JAX
    constructor of the same name takes them) holding a JAX teacher's
    ``params`` (and BN ``state``), in eval mode on ``device``. Every
    parameter and buffer is written, but BN's step counters."""
    model = zoo.registry()[name](**kw)
    sd = _FAMILY_SD[zoo.family_of(name)](params, state, model)
    full = model.state_dict()
    left = {k for k in set(full) - set(sd)
            if not k.endswith("num_batches_tracked")}
    if left or set(sd) - set(full):
        raise KeyError(f"{name}: JAX parameters and the port's differ: "
                       f"{sorted(left or set(sd) - set(full))[:5]}")
    full.update(sd)
    model.load_state_dict(full)
    return model.to(zoo.resolve_device(device)).eval()


def kd_params_from_jax(kd_params, jax_kd_params: Dict[str, Any]):
    """Load a JAX ``init_kd_params`` tree into the port's ``kd_params``
    (``kd/engine.py`` ``init_kd_params``): HWIO -> OIHW for ``fd_proj`` and
    the MGD convs; returns ``kd_params``."""
    sd: Dict[str, torch.Tensor] = {}
    if "fd_proj" in jax_kd_params:
        _conv(sd, "fd_proj", jax_kd_params["fd_proj"])
    for name, p in jax_kd_params.get("mgd", {}).items():
        _conv(sd, f"mgd.{name}", p)
    dev = next(iter(kd_params.parameters())).device if sd else None
    kd_params.load_state_dict({k: v.to(dev) for k, v in sd.items()})
    return kd_params
