"""``slak_tpu`` (params, state) pytrees -> this port's ``state_dict``.

The inverse of ``slak_tpu/utils/convert.py`` ``convert_state_dict``,
reimplemented here (the port imports nothing from ``slak_tpu``). Leaves are
numpy arrays (or anything ``np.asarray`` takes):

  downsample.0.conv.{w,b}       -> downsample_layers.0.0.{weight,bias}
  downsample.0.norm.{scale,bias}-> downsample_layers.0.1.{weight,bias}
  downsample.i.norm / .conv     -> downsample_layers.i.0 / .1
  stages.i.j.lk.<branch>.w      -> stages.i.j.large_kernel.<name>.conv.weight
  stages.i.j.lk.<branch>.bn     -> ....bn.{weight,bias} (+ state mean/var ->
                                   running_mean/running_var)
  stages.i.j.lk.reparam.{w,b}   -> stages.i.j.large_kernel.lkb_reparam.*
  stages.i.j.norm / pwconv1/2 / gamma, norm, head

Layouts: depthwise (kh, kw, C) -> (C, 1, kh, kw); HWIO -> OIHW;
(in, out) -> (out, in). :func:`masks_from_jax` maps a ``slak_tpu`` mask
dict (keyed by dotted param paths) the same way. :func:`to_jax_params` is
the way back for the parameters ({port name: tensor} -> ``slak_tpu``'s
params tree); :func:`adan_state_from_jax` / :func:`adan_state_to_jax` carry
Adan's state (m, v, n, the previous gradient, the step count) between
``slak_tpu``'s ``opt_state`` and the port's :class:`~slak_tpu_torch.train.
optim.Adan`.

:func:`load_torch_checkpoint` unwraps a reference ``checkpoint-*.pth`` into
the state dict ``load_state_dict`` takes: the port's names are already the
reference's, so no conversion is needed.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional

import numpy as np
import torch

_BRANCH = {"LoRA1": "LoRA1", "LoRA2": "LoRA2", "small": "small_conv",
           "origin": "lkb_origin"}


def _t(v) -> torch.Tensor:
    return torch.from_numpy(np.array(v, dtype=np.float32, copy=True))


def from_jax_params(params: Dict[str, Any],
                    state: Optional[Dict[str, Any]] = None
                    ) -> Dict[str, torch.Tensor]:
    """The port's state dict of ``slak_tpu``'s (params, state); without
    ``state`` the parameters alone (also for a params-shaped tree such as
    an optimizer moment)."""
    sd: Dict[str, torch.Tensor] = {}
    for i, ds in enumerate(params["downsample"]):
        conv, norm = ("0", "1") if i == 0 else ("1", "0")
        pre = f"downsample_layers.{i}."
        sd[pre + conv + ".weight"] = _t(ds["conv"]["w"]).permute(3, 2, 0, 1)
        sd[pre + conv + ".bias"] = _t(ds["conv"]["b"])
        sd[pre + norm + ".weight"] = _t(ds["norm"]["scale"])
        sd[pre + norm + ".bias"] = _t(ds["norm"]["bias"])
    for i, blocks in enumerate(params["stages"]):
        for j, bp in enumerate(blocks):
            pre = f"stages.{i}.{j}."
            lk_state = None if state is None else \
                state["stages"][i][j]["lk"]
            for br, p in bp["lk"].items():
                w = _t(p["w"]).permute(2, 0, 1)[:, None]      # (C,1,kh,kw)
                if br == "reparam":
                    sd[pre + "large_kernel.lkb_reparam.weight"] = w
                    sd[pre + "large_kernel.lkb_reparam.bias"] = _t(p["b"])
                    continue
                bpre = pre + f"large_kernel.{_BRANCH[br]}."
                sd[bpre + "conv.weight"] = w
                if "bn" in p:
                    sd[bpre + "bn.weight"] = _t(p["bn"]["scale"])
                    sd[bpre + "bn.bias"] = _t(p["bn"]["bias"])
                if "bn" in p and lk_state is not None:
                    st = lk_state[br]["bn"]
                    sd[bpre + "bn.running_mean"] = _t(st["mean"])
                    sd[bpre + "bn.running_var"] = _t(st["var"])
                    sd[bpre + "bn.num_batches_tracked"] = torch.tensor(0)
            sd[pre + "norm.weight"] = _t(bp["norm"]["scale"])
            sd[pre + "norm.bias"] = _t(bp["norm"]["bias"])
            for n in ("pwconv1", "pwconv2"):
                sd[pre + n + ".weight"] = _t(bp[n]["w"]).t()
                sd[pre + n + ".bias"] = _t(bp[n]["b"])
            if "gamma" in bp:
                sd[pre + "gamma"] = _t(bp["gamma"])
    sd["norm.weight"] = _t(params["norm"]["scale"])
    sd["norm.bias"] = _t(params["norm"]["bias"])
    sd["head.weight"] = _t(params["head"]["w"]).t()
    sd["head.bias"] = _t(params["head"]["b"])
    return {k: v.contiguous() for k, v in sd.items()}


def port_name(jax_path: str) -> str:
    """The port's parameter name of a ``slak_tpu`` dotted param path of a
    weight (``downsample.i.conv.w``, ``stages.i.j.lk.<branch>.w``,
    ``stages.i.j.pwconv1.w``, ``head.w``, ...)."""
    m = re.fullmatch(r"downsample\.(\d+)\.conv\.(w|b)", jax_path)
    if m:
        i = int(m.group(1))
        return (f"downsample_layers.{i}.{0 if i == 0 else 1}."
                + ("weight" if m.group(2) == "w" else "bias"))
    m = re.fullmatch(r"(stages\.\d+\.\d+)\.lk\.(\w+)\.w", jax_path)
    if m:
        if m.group(2) == "reparam":
            return f"{m.group(1)}.large_kernel.lkb_reparam.weight"
        return f"{m.group(1)}.large_kernel.{_BRANCH[m.group(2)]}.conv.weight"
    m = re.fullmatch(r"(stages\.\d+\.\d+\.pwconv\d|head)\.(w|b)", jax_path)
    if m:
        return m.group(1) + (".weight" if m.group(2) == "w" else ".bias")
    raise KeyError(f"no port name for {jax_path!r}")


def to_port_layout(v) -> torch.Tensor:
    """A ``slak_tpu`` weight in the port's layout: (kh, kw, C) depthwise ->
    (C, 1, kh, kw), HWIO -> OIHW, (in, out) -> (out, in)."""
    t = _t(v)
    if t.ndim == 3:
        return t.permute(2, 0, 1)[:, None].contiguous()
    if t.ndim == 4:
        return t.permute(3, 2, 0, 1).contiguous()
    if t.ndim == 2:
        return t.t().contiguous()
    return t


def masks_from_jax(masks: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """``slak_tpu`` DST masks ({dotted path: array}) -> the port's
    ({parameter name: float32 tensor in the port's layout})."""
    return {port_name(n): to_port_layout(m) for n, m in masks.items()}


_BRANCH_BACK = {v: k for k, v in _BRANCH.items()}


def _np(t) -> np.ndarray:
    return np.array(t.detach().cpu().float().numpy(), copy=True)


def to_jax_params(named: Dict[str, Any]) -> Dict[str, Any]:
    """{port parameter name: tensor} (a ``state_dict`` or anything keyed
    like ``named_parameters``; buffers are ignored) -> ``slak_tpu``'s
    params tree with numpy leaves in its layouts: the inverse of the
    params half of :func:`from_jax_params`."""
    ds: Dict[int, Dict] = {}
    st: Dict[int, Dict[int, Dict]] = {}
    params: Dict[str, Any] = {}
    for name, t in named.items():
        v = _np(t)
        m = re.fullmatch(r"downsample_layers\.(\d+)\.(\d)\.(weight|bias)",
                         name)
        if m:
            i, sub, wb = int(m.group(1)), int(m.group(2)), m.group(3)
            if sub == (0 if i == 0 else 1):
                d = ds.setdefault(i, {}).setdefault("conv", {})
                d["w" if wb == "weight" else "b"] = (
                    v.transpose(2, 3, 1, 0) if wb == "weight" else v)
            else:
                ds.setdefault(i, {}).setdefault("norm", {})[
                    "scale" if wb == "weight" else "bias"] = v
            continue
        m = re.fullmatch(r"stages\.(\d+)\.(\d+)\.(.+)", name)
        if m:
            blk = st.setdefault(int(m.group(1)), {}).setdefault(
                int(m.group(2)), {})
            rest = m.group(3)
            b = re.fullmatch(r"large_kernel\.(\w+)\.conv\.weight", rest)
            if b:
                blk.setdefault("lk", {}).setdefault(
                    _BRANCH_BACK[b.group(1)], {})["w"] = \
                    v[:, 0].transpose(1, 2, 0)
                continue
            b = re.fullmatch(r"large_kernel\.(\w+)\.bn\.(weight|bias)", rest)
            if b:
                blk.setdefault("lk", {}).setdefault(
                    _BRANCH_BACK[b.group(1)], {}).setdefault("bn", {})[
                    "scale" if b.group(2) == "weight" else "bias"] = v
                continue
            b = re.fullmatch(r"large_kernel\.lkb_reparam\.(weight|bias)", rest)
            if b:
                blk.setdefault("lk", {}).setdefault("reparam", {})[
                    "w" if b.group(1) == "weight" else "b"] = (
                    v[:, 0].transpose(1, 2, 0) if b.group(1) == "weight"
                    else v)
                continue
            b = re.fullmatch(r"(norm|pwconv1|pwconv2)\.(weight|bias)", rest)
            if b:
                if b.group(1) == "norm":
                    blk.setdefault("norm", {})[
                        "scale" if b.group(2) == "weight" else "bias"] = v
                else:
                    blk.setdefault(b.group(1), {})[
                        "w" if b.group(2) == "weight" else "b"] = (
                        v.T if b.group(2) == "weight" else v)
                continue
            if rest == "gamma":
                blk["gamma"] = v
            continue
        m = re.fullmatch(r"(norm|head)\.(weight|bias)", name)
        if m:
            d = params.setdefault(m.group(1), {})
            if m.group(1) == "norm":
                d["scale" if m.group(2) == "weight" else "bias"] = v
            else:
                d["w" if m.group(2) == "weight" else "b"] = (
                    v.T if m.group(2) == "weight" else v)
    params["downsample"] = [ds[i] for i in sorted(ds)]
    params["stages"] = [[st[i][j] for j in sorted(st[i])] for i in sorted(st)]
    return params


ADAN_KEYS = (("m", "exp_avg"), ("v", "exp_avg_diff"), ("n", "exp_avg_sq"),
             ("pre_grad", "pre_grad"))


def adan_state_from_jax(opt_state: Dict[str, Any],
                        named: Dict[str, torch.Tensor], optimizer) -> None:
    """Write ``slak_tpu``'s Adan ``opt_state`` ({m, v, n, pre_grad:
    params trees; count}) into ``optimizer`` (the port's Adan over the
    parameters ``named``, by port name), in place. A count of 0 leaves the
    optimizer without state, as a fresh one has."""
    count = int(np.asarray(opt_state["count"]))
    if count == 0:
        return
    trees = {k: from_jax_params(opt_state[k]) for k, _ in ADAN_KEYS}
    for name, p in named.items():
        st = optimizer.state[p]
        st["step"] = count
        for k, tk in ADAN_KEYS:
            st[tk] = trees[k][name].to(p.device)


def adan_state_to_jax(optimizer, named: Dict[str, torch.Tensor]
                      ) -> Dict[str, Any]:
    """The port's Adan state -> ``slak_tpu``'s ``opt_state`` (numpy leaves,
    zeros where a parameter has no state yet, ``count`` an int32)."""
    out: Dict[str, Any] = {}
    steps: List[int] = []
    for k, tk in ADAN_KEYS:
        vals = {}
        for name, p in named.items():
            st = optimizer.state.get(p, {})
            vals[name] = st[tk] if tk in st else torch.zeros_like(p)
            if k == "m" and st:
                steps.append(int(st["step"]))
        out[k] = to_jax_params(vals)
    out["count"] = np.int32(steps[0] if steps else 0)
    return out


def load_torch_checkpoint(path: str, prefer_ema: bool = False,
                          model_key: str = "model|module",
                          model_prefix: str = "") -> Dict[str, torch.Tensor]:
    """The model state dict inside a reference checkpoint, unwrapped as
    ``slak_tpu.utils.load_torch_checkpoint`` does (the reference's
    ``main.py:407-409``): '|'-separated ``model_key`` candidates tried in
    order (after ``model_ema`` with ``prefer_ema``, then ``state_dict`` and
    ``model_ema``), and ``model_prefix`` stripped from the names
    (``utils.py:508-544``)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict):
        keys = (["model_ema"] if prefer_ema else []) \
            + model_key.split("|") + ["state_dict", "model_ema"]
        for key in keys:
            if key in ckpt:
                ckpt = ckpt[key]
                break
    if model_prefix:
        ckpt = {k[len(model_prefix):] if k.startswith(model_prefix) else k: v
                for k, v in ckpt.items()}
    return dict(ckpt)


# --- downstream: the backbone's norms, UperNet, Cascade Mask R-CNN ----------


def backbone_from_jax(params: Dict[str, Any],
                      state: Optional[Dict[str, Any]] = None
                      ) -> Dict[str, torch.Tensor]:
    """``slak_tpu.models.backbone`` (params, state) -> the port's
    :class:`~slak_tpu_torch.models.backbone.Backbone` state dict: the SLaK
    tree through :func:`from_jax_params` plus ``norm{i}``."""
    sd = from_jax_params(params, state)
    for k, v in params.items():
        if re.fullmatch(r"norm\d+", k):
            sd[f"{k}.weight"] = _t(v["scale"])
            sd[f"{k}.bias"] = _t(v["bias"])
    return sd


def backbone_to_jax(named: Dict[str, Any]) -> Dict[str, Any]:
    """{backbone parameter name: tensor} -> ``slak_tpu``'s backbone params
    tree (numpy leaves): :func:`to_jax_params` plus ``norm{i}``."""
    tree = to_jax_params(named)
    for name, t in named.items():
        m = re.fullmatch(r"(norm\d+)\.(weight|bias)", name)
        if m:
            tree.setdefault(m.group(1), {})[
                "scale" if m.group(2) == "weight" else "bias"] = _np(t)
    return tree


def _conv_sd(pre: str, p: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    return {pre + ".weight": to_port_layout(p["w"]),
            pre + ".bias": _t(p["b"])}


def upernet_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """``init_upernet``'s params -> the port's
    :class:`~slak_tpu_torch.downstream.segmentation.UperNet` state dict
    (HWIO -> OIHW)."""
    sd: Dict[str, torch.Tensor] = {}
    for k, v in params.items():
        if isinstance(v, list):
            for i, p in enumerate(v):
                sd.update(_conv_sd(f"{k}.{i}", p))
        else:
            sd.update(_conv_sd(k, v))
    return sd


def cascade_from_jax(params: Dict[str, Any],
                     state: Optional[Dict[str, Any]] = None,
                     roi_size: int = 7) -> Dict[str, torch.Tensor]:
    """``init_cascade``'s (params, state) -> the port's
    :class:`~slak_tpu_torch.downstream.detection.CascadeHead` state dict.
    Convs HWIO -> OIHW; dense (in, out) -> (out, in), the box heads' fc
    rows reordered from JAX's (h, w, C) flattening to NCHW's (C, h, w);
    the box heads' BN parameters and running stats; the mask head's
    transposed conv HWIO -> (in, out, kh, kw) and flipped on both
    spatial axes (``lax.conv_transpose`` without ``transpose_kernel``
    applies the kernel unflipped)."""
    sd: Dict[str, torch.Tensor] = {}
    for i, p in enumerate(params["fpn"]["lateral"]):
        sd.update(_conv_sd(f"fpn.lateral.{i}", p))
    for i, p in enumerate(params["fpn"]["out"]):
        sd.update(_conv_sd(f"fpn.out.{i}", p))
    for k in ("conv", "cls", "reg"):
        sd.update(_conv_sd(f"rpn.{k}", params["rpn"][k]))
    for s, sp in enumerate(params["stages"]):
        pre = f"stages.{s}."
        for j, p in enumerate(sp["convs"]):
            sd.update(_conv_sd(pre + f"convs.{j}", p))
        for j, p in enumerate(sp["bn"]):
            sd[pre + f"bn.{j}.weight"] = _t(p["scale"])
            sd[pre + f"bn.{j}.bias"] = _t(p["bias"])
            if state is not None:
                st = state["stages"][s]["bn"][j]
                sd[pre + f"bn.{j}.running_mean"] = _t(st["mean"])
                sd[pre + f"bn.{j}.running_var"] = _t(st["var"])
                sd[pre + f"bn.{j}.num_batches_tracked"] = torch.tensor(0)
        w = _t(sp["fc"]["w"])
        c = w.shape[0] // (roi_size * roi_size)
        sd[pre + "fc.weight"] = w.reshape(roi_size, roi_size, c, -1).permute(
            3, 2, 0, 1).reshape(w.shape[1], -1).contiguous()
        sd[pre + "fc.bias"] = _t(sp["fc"]["b"])
        for k in ("cls", "reg"):
            sd[pre + f"{k}.weight"] = to_port_layout(sp[k]["w"])
            sd[pre + f"{k}.bias"] = _t(sp[k]["b"])
    for j, p in enumerate(params["mask"]["convs"]):
        sd.update(_conv_sd(f"mask.convs.{j}", p))
    sd["mask.deconv.weight"] = _t(params["mask"]["deconv"]["w"]).permute(
        2, 3, 0, 1).flip(2, 3).contiguous()
    sd["mask.deconv.bias"] = _t(params["mask"]["deconv"]["b"])
    sd.update(_conv_sd("mask.logits", params["mask"]["logits"]))
    return sd


def _flatten_paths(tree, prefix=()) -> List[tuple]:
    """The leaf paths of a nested dict / list tree in JAX's tree-flatten
    order: dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _flatten_paths(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in _flatten_paths(v, prefix + (i,))]
    return [prefix]


def read_backbone_npz(path: str, named: Dict[str, Any]
                      ) -> Dict[str, torch.Tensor]:
    """A backbone ``.npz`` as ``slak_tpu``'s seg / det CLIs read it
    (leaves ``p{i}`` in the tree-flatten order of the JAX backbone's
    params) -> the port's backbone parameters by name. ``named``: the
    port backbone's parameters, which give the tree's structure."""
    tree = backbone_to_jax(named)
    paths = _flatten_paths(tree)
    flat = dict(np.load(path))
    if len(flat) != len(paths):
        raise ValueError(f"{path}: {len(flat)} arrays, the backbone has "
                         f"{len(paths)} parameters")
    for i, p in enumerate(paths):
        node = tree
        for k in p[:-1]:
            node = node[k]
        want = np.shape(node[p[-1]])
        got = flat[f"p{i}"]
        if got.shape != want:
            raise ValueError(f"{path}: p{i} ({'.'.join(map(str, p))}) has "
                             f"shape {got.shape}, want {want}")
        node[p[-1]] = got
    return backbone_from_jax(tree)


def load_backbone_checkpoint(path: str, model: torch.nn.Module,
                             key: str = "backbone") -> torch.nn.Module:
    """Initialize a backbone from ``path``: a ``slak_tpu``-written ``.npz``
    (:func:`read_backbone_npz`), one of the port's checkpoints (the
    ``key`` entry of its ``model``: a seg / det CLI checkpoint, or a
    classifier one's model) or a reference ``.pth`` (unwrapped by
    :func:`load_torch_checkpoint`, ``module.`` stripped, and of a whole
    segmentor or detector the ``backbone.`` entries kept, the prefix
    stripped). Parameters the file lacks (the per-stage norms of a
    classifier checkpoint, the classifier of a backbone one) keep their
    values; a name the model lacks is an error."""
    if path.endswith(".npz"):
        sd = read_backbone_npz(path, dict(model.named_parameters()))
    else:
        ck = torch.load(path, map_location="cpu", weights_only=False)
        if isinstance(ck, dict) and str(ck.get("format", "")).startswith(
                "slak_tpu_torch"):
            sd = ck["model"]
            if key in sd and isinstance(sd[key], dict):
                sd = sd[key]
        else:
            sd = load_torch_checkpoint(path)
        sd = {k[7:] if k.startswith("module.") else k: v
              for k, v in sd.items()}
        if any(k.startswith("backbone.") for k in sd):
            # a whole segmentor / detector: its backbone's entries
            sd = {k[9:]: v for k, v in sd.items() if k.startswith(
                "backbone.")}
    dev = next(model.parameters()).device
    missing, unexpected = model.load_state_dict(
        {k: torch.as_tensor(v).to(dev) for k, v in sd.items()}, strict=False)
    if unexpected:
        raise KeyError(f"{path}: names the backbone lacks: "
                       f"{sorted(unexpected)[:5]}")
    return model
