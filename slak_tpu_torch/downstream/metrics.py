"""Downstream quality metrics: ADE20K mIoU and COCO-style AP, port of
``slak_tpu/downstream/metrics.py`` (the numbers of the reference's README
tables: 47.6 / 49.4 / 50.0 mIoU from mmseg's ``IoUMetric``, 48.4 / 41.8
box / mask AP from mmdet's ``CocoMetric`` / pycocotools).

* segmentation: :func:`confusion_matrix` in torch on the predictions'
  device (one ``bincount`` of ``gt * C + pred`` a batch, ignore pixels
  routed to a scratch bin that is dropped) and :func:`seg_scores`, the
  host-side mmseg reductions: per-class IoU = diag / (gt + pred - diag),
  mIoU / mAcc the NaN-mean over classes that appear, aAcc = diag.sum /
  total.

* detection: the COCOeval protocol over ``cascade_predict``'s fixed-shape
  padded outputs (score 0 slots dropped), in numpy, this package's own
  copy of the JAX package's: per image and class a greedy match in score
  order (ties to the later GT), crowd GTs matchable by any number of
  detections at intersection-over-detection-area IoU, the maxDets (1, 10,
  100) caps, the four area ranges with out-of-range unmatched detections
  ignored, the global score-ordered PR curve, right-max precision at 101
  recall points, AP averaged over classes with ground truth. Mask AP
  pastes each 28 x 28 box-relative soft mask into its box on the GT mask
  grid (half-pixel bilinear, binarized at 0.5).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)


# ---------------------------------------------------------------------------
# semantic segmentation: confusion-matrix mIoU
# ---------------------------------------------------------------------------


def confusion_matrix(pred: torch.Tensor, label: torch.Tensor,
                     num_classes: int, ignore_index: int = 255
                     ) -> torch.Tensor:
    """(num_classes, num_classes) int64 confusion counts on the inputs'
    device, rows = GT, columns = prediction: one ``bincount`` of
    ``label * C + pred``, ignore pixels counted in a scratch bin that is
    dropped."""
    pred = pred.reshape(-1).long()
    label = label.reshape(-1).long()
    valid = label != ignore_index
    idx = torch.where(valid, label * num_classes + pred,
                      torch.full_like(label, num_classes ** 2))
    counts = torch.bincount(idx, minlength=num_classes ** 2 + 1)
    return counts[:-1].reshape(num_classes, num_classes)


def seg_scores(cm: np.ndarray) -> Dict[str, float]:
    """mmseg IoUMetric reductions from an accumulated confusion matrix."""
    cm = np.asarray(cm, np.float64)
    diag = np.diag(cm)
    gt = cm.sum(1)
    pr = cm.sum(0)
    union = gt + pr - diag
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = np.where(union > 0, diag / union, np.nan)
        acc = np.where(gt > 0, diag / gt, np.nan)
    return {
        "mIoU": float(np.nanmean(iou)) if np.isfinite(iou).any() else 0.0,
        "mAcc": float(np.nanmean(acc)) if np.isfinite(acc).any() else 0.0,
        "aAcc": float(diag.sum() / max(cm.sum(), 1.0)),
        "per_class_iou": iou,
    }


# ---------------------------------------------------------------------------
# detection: COCO-style AP
# ---------------------------------------------------------------------------


def box_iou(a: np.ndarray, b: np.ndarray,
            crowd: Optional[np.ndarray] = None) -> np.ndarray:
    """(N, 4) x (M, 4) xyxy -> (N, M) IoU. ``crowd`` flags columns whose
    denominator is the *det* area (pycocotools ``maskUtils.iou`` iscrowd
    semantics: a det fully inside a crowd region scores 1)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.prod(np.clip(a[:, 2:] - a[:, :2], 0, None), -1)
    area_b = np.prod(np.clip(b[:, 2:] - b[:, :2], 0, None), -1)
    union = area_a[:, None] + area_b[None, :] - inter
    if crowd is not None and np.any(crowd):
        union = np.where(np.asarray(crowd, bool)[None, :],
                         area_a[:, None], union)
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def _resize_bilinear(m: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """Half-pixel-centers bilinear resize of a 2-D array (numpy), the
    sample positions clamped to the array's edges."""
    ih, iw = m.shape
    ys = (np.arange(oh) + 0.5) * ih / oh - 0.5
    xs = (np.arange(ow) + 0.5) * iw / ow - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, ih - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, iw - 1)
    y1 = np.minimum(y0 + 1, ih - 1)
    x1 = np.minimum(x0 + 1, iw - 1)
    fy = np.clip(ys - y0, 0.0, 1.0)[:, None]
    fx = np.clip(xs - x0, 0.0, 1.0)[None, :]
    top = m[y0][:, x0] * (1 - fx) + m[y0][:, x1] * fx
    bot = m[y1][:, x0] * (1 - fx) + m[y1][:, x1] * fx
    return top * (1 - fy) + bot * fy


def paste_mask(mask: np.ndarray, box: np.ndarray, grid_hw: Tuple[int, int],
               img_hw: Tuple[int, int], thr: float = 0.5) -> np.ndarray:
    """Paste a box-relative (m, m) soft mask into a binary (Gh, Gw) grid
    covering the full image extent (the GT-mask grid)."""
    gh, gw = grid_hw
    sy = gh / img_hw[0]
    sx = gw / img_hw[1]
    x1, y1, x2, y2 = box
    gx1 = int(np.floor(x1 * sx))
    gy1 = int(np.floor(y1 * sy))
    gx2 = int(np.ceil(x2 * sx))
    gy2 = int(np.ceil(y2 * sy))
    gx1, gy1 = max(gx1, 0), max(gy1, 0)
    gx2, gy2 = min(gx2, gw), min(gy2, gh)
    out = np.zeros((gh, gw), bool)
    if gx2 <= gx1 or gy2 <= gy1:
        return out
    out[gy1:gy2, gx1:gx2] = (
        _resize_bilinear(np.asarray(mask, np.float64),
                         gy2 - gy1, gx2 - gx1) >= thr)
    return out


def _mask_bounds(masks: np.ndarray) -> np.ndarray:
    """(K, Gh, Gw) bool -> (K, 4) tight [y1, x1, y2, x2) bounds (zeros for
    empty masks)."""
    k = masks.shape[0]
    out = np.zeros((k, 4), np.int64)
    any_row = masks.any(2)
    any_col = masks.any(1)
    for i in range(k):
        ys = np.flatnonzero(any_row[i])
        if ys.size == 0:
            continue
        xs = np.flatnonzero(any_col[i])
        out[i] = (ys[0], xs[0], ys[-1] + 1, xs[-1] + 1)
    return out


def mask_iou(pred: Sequence[np.ndarray], gt: Sequence[np.ndarray],
             crowd: Optional[np.ndarray] = None) -> np.ndarray:
    """(N binary grids) x (M binary grids) -> (N, M) IoU; intersections
    computed on tight-bbox crops so COCO-scale grids stay cheap. ``crowd``
    columns use the det area as denominator (pycocotools iscrowd)."""
    n, m = len(pred), len(gt)
    out = np.zeros((n, m))
    if n == 0 or m == 0:
        return out
    pred = np.asarray(pred, bool)
    gt = np.asarray(gt, bool)
    pa = pred.reshape(n, -1).sum(1).astype(np.float64)
    ga = gt.reshape(m, -1).sum(1).astype(np.float64)
    pb = _mask_bounds(pred)
    gb = _mask_bounds(gt)
    crowd = (np.zeros(m, bool) if crowd is None
             else np.asarray(crowd, bool))
    for i in range(n):
        if pa[i] == 0:
            continue
        y1 = np.maximum(pb[i, 0], gb[:, 0])
        x1 = np.maximum(pb[i, 1], gb[:, 1])
        y2 = np.minimum(pb[i, 2], gb[:, 2])
        x2 = np.minimum(pb[i, 3], gb[:, 3])
        for j in range(m):
            if ga[j] == 0 or y2[j] <= y1[j] or x2[j] <= x1[j]:
                continue
            inter = np.count_nonzero(
                pred[i, y1[j]:y2[j], x1[j]:x2[j]]
                & gt[j, y1[j]:y2[j], x1[j]:x2[j]])
            denom = pa[i] if crowd[j] else pa[i] + ga[j] - inter
            out[i, j] = inter / denom if denom > 0 else 0.0
    return out


# pycocotools areaRng: all / small / medium / large
AREA_RANGES = ((0.0, 1e10), (0.0, 32.0 ** 2), (32.0 ** 2, 96.0 ** 2),
               (96.0 ** 2, 1e10))
AREA_LABELS = ("all", "small", "medium", "large")
MAX_DETS = (1, 10, 100)


def _match_img_cat(iou: np.ndarray, n_real: int, crowd: np.ndarray,
                   thrs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The pycocotools ``evaluateImg`` greedy walk, vectorized over the
    IoU thresholds. ``iou`` is (D, G) with dets in score order and GTs
    sorted ignore-last (the first ``n_real`` are non-ignored); ``crowd``
    flags (sorted) GT columns that stay matchable after being taken.

    Tie rule: the reference scan updates its best on ``>=``, so equal
    IoUs go to the LATER GT; an ignored GT never outbids a real match
    (the scan breaks at the ignore boundary once a real match exists).
    Returns (dtm (T, D) matched flags, dt_ig (T, D) matched-to-ignored
    flags)."""
    D, G = iou.shape
    T = len(thrs)
    thr = np.minimum(thrs, 1 - 1e-10)[:, None]
    gtm = np.zeros((T, G), bool)
    dtm = np.zeros((T, D), bool)
    dt_ig = np.zeros((T, D), bool)
    trange = np.arange(T)
    for d in range(D):
        row = iou[d]
        m = np.full(T, -1, np.int64)
        if n_real:
            cand = (~gtm[:, :n_real]) & (row[None, :n_real] >= thr)
            vals = np.where(cand, row[:n_real], -1.0)
            m_real = n_real - 1 - np.argmax(vals[:, ::-1], axis=1)
            m = np.where(cand.any(1), m_real, m)
        if G > n_real:
            avail = (~gtm[:, n_real:]) | crowd[None, n_real:]
            cand_i = avail & (row[None, n_real:] >= thr)
            vals_i = np.where(cand_i, row[n_real:], -1.0)
            m_ig = G - 1 - np.argmax(vals_i[:, ::-1], axis=1)
            m = np.where((m < 0) & cand_i.any(1), m_ig, m)
        hit = m >= 0
        if not hit.any():
            continue
        dtm[hit, d] = True
        dt_ig[:, d] = hit & (m >= n_real)
        gtm[trange[hit], m[hit]] = True
    return dtm, dt_ig


def _accumulate(per_img, thrs: np.ndarray, max_dets: Sequence[int]
                ) -> Tuple[np.ndarray, np.ndarray]:
    """pycocotools ``accumulate`` for one (class, area-range) cell:
    ``per_img`` is a list of (scores (D,), dtm (T, D), dt_ig (T, D),
    n_real) records. Returns (precision (T, R, M), recall (T, M)),
    -1 where the class has no GT in range."""
    T = len(thrs)
    R = len(REC_THRS)
    M = len(max_dets)
    precision = np.full((T, R, M), -1.0)
    recall = np.full((T, M), -1.0)
    npig = sum(r[3] for r in per_img)
    if npig == 0:
        return precision, recall
    for mi, md in enumerate(max_dets):
        scores = np.concatenate([r[0][:md] for r in per_img]) \
            if per_img else np.zeros(0)
        order = np.argsort(-scores, kind="mergesort")
        if per_img:
            dtm = np.concatenate([r[1][:, :md] for r in per_img],
                                 axis=1)[:, order]
            dt_ig = np.concatenate([r[2][:, :md] for r in per_img],
                                   axis=1)[:, order]
        else:
            dtm = dt_ig = np.zeros((T, 0), bool)
        tps = dtm & ~dt_ig
        fps = ~dtm & ~dt_ig
        tp = np.cumsum(tps, axis=1, dtype=np.float64)
        fp = np.cumsum(fps, axis=1, dtype=np.float64)
        nd = tp.shape[1]
        rc = tp / npig
        pr = tp / np.maximum(fp + tp, np.spacing(1))
        # right-max interpolation (monotone non-increasing precision)
        pr = np.maximum.accumulate(pr[:, ::-1], axis=1)[:, ::-1]
        recall[:, mi] = rc[:, -1] if nd else 0.0
        for ti in range(T):
            inds = np.searchsorted(rc[ti], REC_THRS, side="left")
            ok = inds < nd
            q = np.zeros(R)
            q[ok] = pr[ti, inds[ok]]
            precision[ti, :, mi] = q
    return precision, recall


def coco_ap(detections: List[Dict[str, np.ndarray]],
            ground_truths: List[Dict[str, np.ndarray]],
            num_classes: int,
            iou_type: str = "bbox",
            img_hw: Optional[Tuple[int, int]] = None,
            max_dets: Sequence[int] = MAX_DETS) -> Dict[str, float]:
    """COCO AP/AR over per-image prediction/GT dicts — the pycocotools
    ``COCOeval`` protocol (see the module docstring).

    detections[i]: ``boxes (D,4)``, ``scores (D,)``, ``labels (D,)``
      [+ ``masks (D,m,m)`` box-relative soft masks for iou_type='segm'];
      padded slots carry score 0 and are dropped.
    ground_truths[i]: ``boxes (G,4)``, ``labels (G,)``, ``valid (G,)``
      [+ ``masks (G,Gh,Gw)`` full-image binary grids for 'segm';
      + optional ``iscrowd (G,)`` crowd/ignore flags (pycocotools: a
      crowd GT is never a miss and absorbs any number of dets at
      intersection-over-det-area IoU); + optional ``areas (G,)`` in
      image pixels for the area-range splits (defaults to the box area
      for 'bbox' / the mask area for 'segm' — COCO's own protocol uses
      the annotation's segmentation area for both)].

    Returns the 12 standard metrics (fractions in [0, 1]): AP, AP50,
    AP75, APs/APm/APl, AR1/AR10/AR100, ARs/ARm/ARl.
    """
    assert len(detections) == len(ground_truths)
    thrs = np.asarray(IOU_THRS)
    T = len(thrs)
    A = len(AREA_RANGES)
    M = len(max_dets)
    md_max = max(max_dets)
    # per class: list of per-image records
    per_cls: List[List[dict]] = [[] for _ in range(num_classes)]

    for det, gt in zip(detections, ground_truths):
        keep = np.asarray(det["scores"]) > 0
        d_boxes = np.asarray(det["boxes"])[keep]
        d_scores = np.asarray(det["scores"])[keep]
        d_labels = np.asarray(det["labels"])[keep].astype(int)
        gv = np.asarray(gt["valid"]).astype(bool)
        g_boxes = np.asarray(gt["boxes"])[gv]
        g_labels = np.asarray(gt["labels"])[gv].astype(int)
        g_crowd = (np.asarray(gt["iscrowd"])[gv].astype(bool)
                   if "iscrowd" in gt else np.zeros(gv.sum(), bool))
        g_areas = (np.asarray(gt["areas"])[gv].astype(np.float64)
                   if "areas" in gt else None)

        if iou_type == "segm":
            assert img_hw is not None, "segm AP needs img_hw"
            g_masks = np.asarray(gt["masks"])[gv] >= 0.5
            grid_hw = g_masks.shape[-2:] if g_masks.size else (1, 1)
            # grid-pixel -> image-pixel area scale (the range thresholds
            # are denominated in image pixels)
            a_scale = (img_hw[0] * img_hw[1]) / max(
                grid_hw[0] * grid_hw[1], 1)
            d_masks = np.asarray(
                [paste_mask(m, b, grid_hw, img_hw)
                 for m, b in zip(np.asarray(det["masks"])[keep], d_boxes)]
                if keep.any() else np.zeros((0,) + tuple(grid_hw), bool))
            d_areas_all = d_masks.sum((1, 2)) * a_scale
            if g_areas is None:
                g_areas = g_masks.sum((1, 2)) * a_scale if g_masks.size \
                    else np.zeros(len(g_masks))
        else:
            d_areas_all = np.prod(
                np.clip(d_boxes[:, 2:] - d_boxes[:, :2], 0, None), -1) \
                if len(d_boxes) else np.zeros(0)
            if g_areas is None:
                g_areas = np.prod(
                    np.clip(g_boxes[:, 2:] - g_boxes[:, :2], 0, None), -1) \
                    if len(g_boxes) else np.zeros(0)

        labels_present = np.unique(np.concatenate([d_labels, g_labels])) \
            if (d_labels.size or g_labels.size) else np.zeros(0, int)
        for c in labels_present:
            dsel = np.flatnonzero(d_labels == c)
            gsel = np.flatnonzero(g_labels == c)
            order = dsel[np.argsort(-d_scores[dsel],
                                    kind="mergesort")][:md_max]
            if iou_type == "segm":
                iou = mask_iou(d_masks[order], g_masks[gsel],
                               crowd=g_crowd[gsel])
            else:
                iou = box_iou(d_boxes[order], g_boxes[gsel],
                              crowd=g_crowd[gsel])
            per_cls[c].append({
                "scores": d_scores[order],
                "d_areas": d_areas_all[order],
                "iou": iou,
                "g_areas": g_areas[gsel],
                "g_crowd": g_crowd[gsel],
            })

    precision = np.full((T, len(REC_THRS), num_classes, A, M), -1.0)
    recall = np.full((T, num_classes, A, M), -1.0)
    for c in range(num_classes):
        if not per_cls[c]:
            continue
        for ai, (lo, hi) in enumerate(AREA_RANGES):
            records = []
            for r in per_cls[c]:
                g_ig = r["g_crowd"] | (r["g_areas"] < lo) \
                    | (r["g_areas"] > hi)
                gorder = np.argsort(g_ig, kind="mergesort")
                n_real = int((~g_ig).sum())
                dtm, dt_ig = _match_img_cat(
                    r["iou"][:, gorder], n_real, r["g_crowd"][gorder],
                    thrs)
                out_rng = (r["d_areas"] < lo) | (r["d_areas"] > hi)
                dt_ig = dt_ig | (~dtm & out_rng[None, :])
                records.append((r["scores"], dtm, dt_ig, n_real))
            precision[:, :, c, ai, :], recall[:, c, ai, :] = \
                _accumulate(records, thrs, max_dets)

    def _mean(x):
        x = x[x > -1]
        return float(np.mean(x)) if x.size else 0.0

    mi100 = max_dets.index(100) if 100 in max_dets else M - 1
    out = {
        "AP": _mean(precision[:, :, :, 0, mi100]),
        "AP50": _mean(precision[0, :, :, 0, mi100]),
        "AP75": _mean(precision[5, :, :, 0, mi100]),
        "APs": _mean(precision[:, :, :, 1, mi100]),
        "APm": _mean(precision[:, :, :, 2, mi100]),
        "APl": _mean(precision[:, :, :, 3, mi100]),
        "ARs": _mean(recall[:, :, 1, mi100]),
        "ARm": _mean(recall[:, :, 2, mi100]),
        "ARl": _mean(recall[:, :, 3, mi100]),
    }
    for mi, md in enumerate(max_dets):
        out[f"AR{md}"] = _mean(recall[:, :, 0, mi])
    return out
