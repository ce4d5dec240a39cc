"""Dynamic sparse training (prune and grow): port of
``slak_tpu/sparsity/masking.py`` (the reference's ``Masking`` engine,
sparse_core.py:67-407, and its registries, funcs.py:374-392).

Masks are float32 {0, 1} tensors keyed by the port's parameter names, in
the parameters' own (torch) layouts: depthwise (C, 1, kh, kw), dense
(out, in), conv OIHW. Counts (``nnz``, ``ceil(prune_rate * nnz)``) are
float32 tensors as in the JAX version, and every rank is a stable
ascending sort, so equal scores break ties by index order (FIDELITY #4);
the index order is the torch layout's. Random draws come from the
:class:`MaskState`'s ``torch.Generator``; they are not JAX's bits.

  * maskable: every parameter with ndim >= 2 (``only_L``: the LoRA
    branches);
  * init: uniform / ERK / snip / resume, dropping layers that come out at
    least 0.99 dense;
  * :func:`apply_mask` after every optimizer step;
  * every ``update_frequency`` steps :func:`truncate_weights`: a
    magnitude / SET / global-magnitude prune of ``ceil(rate * nnz)``, then
    the same count regrown by random / gradient / momentum / mix /
    random_unfired / momentum_neuron / global_momentum_growth, at the
    cosine-decayed prune rate (:func:`cosine_prune_rate`);
  * :func:`sparsity_report`: per-layer and overall density, ITOP's fired
    ratio (sparse_core.py:376-402).
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

Masks = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class MaskConfig:
    """Sparsity flags, mirroring the reference CLI (main.py:207-221)."""
    sparsity: float = 0.4
    sparse_init: str = "snip"        # uniform | ERK | snip | resume
    prune_mode: str = "magnitude"    # magnitude | SET | global_magnitude
    growth_mode: str = "random"      # random | gradient | momentum | mix |
    #   random_unfired | momentum_neuron | global_momentum_growth
    redistribution_mode: str = "none"
    prune_rate: float = 0.5
    eta_min: float = 0.005
    update_frequency: Optional[int] = 100
    fix: bool = False
    only_L: bool = False
    mix: float = 0.5

    @property
    def density(self) -> float:
        return 1.0 - self.sparsity


@dataclasses.dataclass
class MaskState:
    masks: Masks                     # float32 {0, 1}
    fired: Masks                     # ITOP union of every mask so far
    steps: int
    generator: torch.Generator       # random growth draws


def select_maskable(named: Dict[str, torch.Tensor],
                    only_L: bool = False) -> Dict[str, torch.Tensor]:
    """The tensors that get masks: ndim >= 2 (sparse_core.py:123),
    optionally only the LoRA branches."""
    return {n: t for n, t in named.items()
            if t.ndim >= 2 and (not only_L or re.search(r"\bLoRA", n))}


# --- init (sparse_core.py:141-261) -------------------------------------------

def erk_densities(shapes: Dict[str, Tuple[int, ...]], density: float,
                  erk_power_scale: float = 1.0) -> Dict[str, float]:
    """Erdos-Renyi-Kernel per-layer densities with the dense-layer
    promotion loop (sparse_core.py:183-241)."""
    dense_layers = set()
    while True:
        divisor, rhs = 0.0, 0.0
        raw = {}
        for name, shape in shapes.items():
            n_param = float(np.prod(shape))
            if name in dense_layers:
                rhs -= n_param * (1.0 - density)
            else:
                rhs += n_param * density
                raw[name] = (np.sum(shape) / np.prod(shape)) ** erk_power_scale
                divisor += raw[name] * n_param
        epsilon = rhs / divisor
        max_prob = max(raw.values())
        if max_prob * epsilon > 1.0:
            for name, p in raw.items():
                if p == max_prob:
                    dense_layers.add(name)
        else:
            break
    return {name: 1.0 if name in dense_layers else float(epsilon * raw[name])
            for name in shapes}


def snip_sparsities(loss_fn: Callable[[], torch.Tensor],
                    maskable: Dict[str, torch.Tensor],
                    density: float, group=None) -> Dict[str, float]:
    """SNIP (sparse_core.py:11-47): saliency |w * dL/dw| on one batch
    (``loss_fn()`` evaluates it with the current weights), a global top-k
    threshold, survivors strictly above it, per-layer sparsities. Under
    data parallel (``group``) each rank's loss is over its shard of the
    global first batch and the gradients are averaged over the group, so
    every rank scores the same saliencies."""
    names = list(maskable)
    grads = torch.autograd.grad(loss_fn(), [maskable[n] for n in names])
    if group is not None:
        from slak_tpu_torch.parallel.mesh import all_reduce_
        grads = [g.contiguous() for g in grads]
        all_reduce_(grads, "mean", group)
    scores = {n: (maskable[n] * g).abs().detach()
              for n, g in zip(names, grads)}
    all_scores = torch.cat([s.flatten() for s in scores.values()])
    keep = int(all_scores.numel() * density)
    thr = torch.topk(all_scores, max(keep, 1)).values[-1]
    return {n: float(1.0 - (s > thr).float().sum() / s.numel())
            for n, s in scores.items()}


def _uniform(shape, generator, device) -> torch.Tensor:
    return torch.rand(shape, generator=generator,
                      device=generator.device).to(device)


def init_masks(named: Dict[str, torch.Tensor], cfg: MaskConfig,
               generator: torch.Generator,
               loss_fn: Optional[Callable[[], torch.Tensor]] = None,
               masks: Optional[Masks] = None, group=None) -> MaskState:
    """The initial MaskState. ``masks`` given: those (resuming a run, or
    masks shared with another implementation); else by ``sparse_init``
    (``snip`` needs ``loss_fn``, one batch's loss, its gradients averaged
    over ``group`` when one is given)."""
    maskable = select_maskable(named, cfg.only_L)
    if masks is not None:
        out = {n: m.float().to(maskable[n].device) for n, m in masks.items()}
    else:
        mode, density = cfg.sparse_init, cfg.density
        if mode == "resume":
            dens = None
            out = {n: (w != 0).float() for n, w in maskable.items()}
        elif mode == "uniform":
            dens = {n: density for n in maskable}
        elif mode == "ERK":
            dens = erk_densities({n: tuple(w.shape)
                                  for n, w in maskable.items()}, density)
        elif mode == "snip":
            if loss_fn is None:
                raise ValueError("snip init needs loss_fn over one batch")
            dens = {n: 1.0 - s for n, s in
                    snip_sparsities(loss_fn, maskable, density,
                                    group).items()}
        else:
            raise ValueError(f"unknown sparse_init {mode!r}")
        if dens is not None:
            out = {n: (_uniform(w.shape, generator, w.device) < dens[n]
                       ).float() for n, w in maskable.items()}
        # drop layers that came out (almost) dense (sparse_core.py:255-259)
        out = {n: m for n, m in out.items() if float(m.mean()) < 0.99}
    return MaskState(masks=out, fired={n: m.clone() for n, m in out.items()},
                     steps=0, generator=generator)


# --- schedule, apply ---------------------------------------------------------

def cosine_prune_rate(step: int, prune_rate: float, t_max: int,
                      eta_min: float = 0.005) -> torch.Tensor:
    """torch CosineAnnealingLR after ``step`` steps, as a float32 scalar."""
    s = torch.tensor(float(min(step, t_max)), dtype=torch.float32)
    return eta_min + (prune_rate - eta_min) * 0.5 * (
        1.0 + torch.cos(math.pi * s / float(t_max)))


@torch.no_grad()
def apply_mask(named: Dict[str, torch.Tensor], masks: Masks):
    """In place: w *= mask for every masked tensor (sparse_core.py:316)."""
    for n, m in masks.items():
        named[n].mul_(m.to(named[n].dtype))


# --- prune and grow (funcs.py) -----------------------------------------------

def _ranks_ascending(x: torch.Tensor) -> torch.Tensor:
    """rank[i] = position of x[i] in a stable ascending sort (ties by
    index)."""
    flat = x.flatten()
    order = torch.argsort(flat, stable=True)
    ranks = torch.empty_like(order)
    ranks[order] = torch.arange(flat.numel(), device=x.device)
    return ranks.reshape(x.shape)


def _below(ranks: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """ranks < k for an integral-valued float k."""
    return ranks < k.to(ranks.device).long()


def magnitude_prune(mask, weight, prune_rate):
    """funcs.py:56-114: zero the (zeros + ceil(rate * nnz)) smallest |w|."""
    nnz = mask.sum()
    num_remove = torch.ceil(prune_rate * nnz)
    k = (mask.numel() - nnz) + num_remove
    pruned = torch.where(_below(_ranks_ascending(weight.abs()), k),
                         torch.zeros_like(mask), mask)
    return torch.where(num_remove == 0, (weight != 0).to(mask.dtype), pruned)


def set_prune(mask, weight, prune_rate):
    """funcs.py:149-164 ('SET'): half smallest |w|, half most negative."""
    nnz = mask.sum()
    num_remove = torch.ceil(prune_rate * nnz)
    k_mag = (mask.numel() - nnz) + torch.ceil(num_remove / 2.0)
    k_neg = torch.ceil(num_remove / 2.0)
    kill = (_below(_ranks_ascending(weight.abs()), k_mag)
            | _below(_ranks_ascending(weight), k_neg))
    pruned = torch.where(kill, torch.zeros_like(mask), mask)
    return torch.where(num_remove == 0, (weight != 0).to(mask.dtype), pruned)


def random_growth(generator, new_mask, regrowth):
    """funcs.py:170-175: Bernoulli(regrowth / zeros) over the tensor, OR'd
    in; the regrown count is binomial around ``regrowth``."""
    n_zeros = (new_mask == 0).sum()
    p = torch.where(n_zeros > 0, regrowth / n_zeros.clamp(min=1),
                    torch.zeros_like(regrowth))
    coins = _uniform(new_mask.shape, generator, new_mask.device) < p
    return torch.maximum(new_mask, coins.to(new_mask.dtype))


def score_growth(new_mask, score, regrowth):
    """Top-|score| growth over masked positions (gradient_growth,
    funcs.py:196-205; momentum_growth, :227-299)."""
    masked = score.abs() * (new_mask == 0).to(score.dtype)
    grown = _below(_ranks_ascending(-masked), regrowth)
    return torch.maximum(new_mask, grown.to(new_mask.dtype))


def random_unfired_growth(generator, new_mask, fired, regrowth):
    """funcs.py:177-194: never-fired positions first, the overflow at
    random."""
    num_unfired = (fired == 0).sum()
    pri = _uniform(new_mask.shape, generator, new_mask.device) \
        + (fired != 0).float() * 2.0
    grown_a = torch.maximum(
        new_mask, _below(_ranks_ascending(pri), regrowth).to(new_mask.dtype))
    with_unfired = torch.maximum(new_mask, (fired == 0).to(new_mask.dtype))
    n = (with_unfired == 0).sum().clamp(min=1)
    coins = _uniform(new_mask.shape, generator, new_mask.device) \
        < (regrowth - num_unfired) / n
    grown_b = torch.maximum(with_unfired, coins.to(new_mask.dtype))
    return torch.where(regrowth <= num_unfired, grown_a, grown_b)


def global_magnitude_prune(masks: Masks, weights: Dict[str, torch.Tensor],
                           prune_rate) -> Masks:
    """funcs.py:116-148 with exact counts: the ceil(rate * total nnz)
    smallest |w| across all masked layers at once."""
    names = list(masks)
    all_w = torch.cat([weights[n].float().abs().flatten() for n in names])
    total_nnz = sum(masks[n].sum() for n in names)
    num_remove = torch.ceil(prune_rate * total_nnz)
    kill = _below(_ranks_ascending(all_w), all_w.numel() - total_nnz
                  + num_remove)
    out, off = {}, 0
    for n in names:
        m = masks[n]
        k = kill[off:off + m.numel()].reshape(m.shape)
        out[n] = torch.where(num_remove == 0,
                             (weights[n] != 0).to(m.dtype),
                             torch.where(k, torch.zeros_like(m), m))
        off += m.numel()
    return out


def global_momentum_growth(masks: Masks, scores: Dict[str, torch.Tensor],
                           regrowth) -> Masks:
    """funcs.py:330-372 with exact counts: the ``regrowth`` largest
    |momentum| masked positions across all layers."""
    names = list(masks)
    all_s = torch.cat([(scores[n].float().abs()
                        * (masks[n] == 0).float()).flatten() for n in names])
    grow = _below(_ranks_ascending(-all_s), regrowth)
    out, off = {}, 0
    for n in names:
        m = masks[n]
        g = grow[off:off + m.numel()].reshape(m.shape)
        out[n] = torch.maximum(m, g.to(m.dtype))
        off += m.numel()
    return out


def mix_growth(generator, new_mask, score, regrowth, mix: float):
    """funcs.py:207-224: gradient top-k for a ``mix`` share, random for
    the rest."""
    g = torch.floor(regrowth * mix)
    return random_growth(generator, score_growth(new_mask, score, g),
                         regrowth - g)


def momentum_neuron_growth(new_mask, score, regrowth):
    """funcs.py:301-327 over the output neurons, rows of dim 0 of the torch
    layout (the reference's)."""
    m = score.abs()
    axes = tuple(range(1, m.ndim))
    v = m.mean(axes)
    v = v / v.sum().clamp(min=1e-12)
    slots = (new_mask == 0).sum(axes)
    per_neuron = torch.minimum(torch.floor(v * regrowth), slots.float())
    flat = (m * (new_mask == 0).to(m.dtype)).reshape(m.shape[0], -1)
    sorted_desc = -torch.sort(-flat, dim=1).values
    idx = (per_neuron.long() - 1).clamp(0, flat.shape[1] - 1)
    thr = sorted_desc.gather(1, idx[:, None])
    ok = (per_neuron >= 10) & (thr[:, 0] > 0.0)
    grow = (flat > thr) & ok[:, None]
    return torch.maximum(new_mask, grow.reshape(new_mask.shape).to(
        new_mask.dtype))


@torch.no_grad()
def truncate_weights(state: MaskState, named: Dict[str, torch.Tensor],
                     cfg: MaskConfig, prune_rate,
                     grads: Optional[Dict[str, torch.Tensor]] = None,
                     momentum: Optional[Dict[str, torch.Tensor]] = None
                     ) -> MaskState:
    """One prune-and-grow update (sparse_core.py:335-357). Returns the new
    state; the new masks are applied to ``named`` in place. ``grads`` /
    ``momentum`` ({name: tensor}) feed the gradient / momentum modes."""
    weights = {n: named[n].float() for n in state.masks}
    gen = state.generator
    if cfg.prune_mode == "global_magnitude":
        pruned = global_magnitude_prune(state.masks, weights, prune_rate)
    else:
        fn = {"magnitude": magnitude_prune, "SET": set_prune}.get(
            cfg.prune_mode)
        if fn is None:
            raise ValueError(f"unknown prune_mode {cfg.prune_mode!r}")
        pruned = {n: fn(m, weights[n], prune_rate)
                  for n, m in state.masks.items()}

    if cfg.growth_mode == "global_momentum_growth":
        total = torch.floor(sum(state.masks[n].sum() - pruned[n].sum()
                                for n in state.masks))
        new = global_momentum_growth(pruned, momentum, total)
    else:
        new = {}
        for n, mask in state.masks.items():
            p = pruned[n]
            regrowth = torch.floor(mask.sum() - p.sum())
            mode = cfg.growth_mode
            if mode == "random":
                new[n] = random_growth(gen, p, regrowth)
            elif mode == "gradient":
                new[n] = score_growth(p, grads[n], regrowth)
            elif mode == "momentum":
                new[n] = score_growth(p, momentum[n], regrowth)
            elif mode == "mix":
                new[n] = mix_growth(gen, p, grads[n], regrowth, cfg.mix)
            elif mode == "random_unfired":
                new[n] = random_unfired_growth(gen, p, state.fired[n],
                                               regrowth)
            elif mode == "momentum_neuron":
                new[n] = momentum_neuron_growth(p, momentum[n], regrowth)
            else:
                raise ValueError(f"unknown growth_mode {mode!r}")
    apply_mask(named, new)
    fired = {n: torch.maximum(state.fired[n], new[n]) for n in new}
    return MaskState(masks=new, fired=fired, steps=state.steps,
                     generator=gen)


# --- observability (sparse_core.py:376-402) ----------------------------------

def sparsity_report(state: MaskState) -> Dict[str, Any]:
    """Per-layer densities, the overall density and the ITOP fired ratio
    (the share of maskable weights ever live), as ``slak_tpu``'s
    ``sparsity_report``; every count comes to the host in one transfer."""
    names = list(state.masks)
    if not names:
        return {"layers": {}, "density": 0.0, "fired_ratio": 0.0}
    counts = torch.stack(
        [state.masks[n].double().sum() for n in names]
        + [state.fired[n].double().sum() for n in names]).tolist()
    nnz, fired = counts[:len(names)], counts[len(names):]
    sizes = [state.masks[n].numel() for n in names]
    total = float(sum(sizes))
    return {
        "layers": {n: c / s for n, c, s in zip(names, nnz, sizes)},
        "density": sum(nnz) / max(total, 1),
        "fired_ratio": sum(fired) / max(total, 1),
    }
