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
dict (keyed by dotted param paths) the same way.
"""

from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np
import torch

_BRANCH = {"LoRA1": "LoRA1", "LoRA2": "LoRA2", "small": "small_conv",
           "origin": "lkb_origin"}


def _t(v) -> torch.Tensor:
    return torch.from_numpy(np.array(v, dtype=np.float32, copy=True))


def from_jax_params(params: Dict[str, Any], state: Dict[str, Any]
                    ) -> Dict[str, torch.Tensor]:
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
            lk_state = state["stages"][i][j]["lk"]
            for br, p in bp["lk"].items():
                w = _t(p["w"]).permute(2, 0, 1)[:, None]      # (C,1,kh,kw)
                if br == "reparam":
                    sd[pre + "large_kernel.lkb_reparam.weight"] = w
                    sd[pre + "large_kernel.lkb_reparam.bias"] = _t(p["b"])
                    continue
                bpre = pre + f"large_kernel.{_BRANCH[br]}."
                sd[bpre + "conv.weight"] = w
                if "bn" in p:
                    st = lk_state[br]["bn"]
                    sd[bpre + "bn.weight"] = _t(p["bn"]["scale"])
                    sd[bpre + "bn.bias"] = _t(p["bn"]["bias"])
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
