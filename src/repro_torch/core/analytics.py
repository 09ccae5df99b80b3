"""Streaming propagation analytics: online accumulators in the round loop
(port of ``repro/core/analytics.py``, DESIGN.md §10).

The paper's propagation quantities — per-node accuracy AUC, the IID/OOD
gap and the round at which OOD knowledge *arrives* at each node — come
from ``core.propagation``'s host oracles over a whole ``(R, n)`` history.
:class:`AnalyticsSpec` computes the same numbers as a carry that every
eval round folds into:

* the running trapezoid sum ``Σ ½·(r_k − r_{k−1})·(a_k + a_{k−1})`` over
  the eval rounds, finalized to the span-normalised mean height as
  ``propagation.per_node_auc`` does;
* the first eval round at which a node's accuracy reaches
  ``arrival_threshold`` (``NO_ARRIVAL`` if never), as
  ``propagation.arrival_rounds``;
* the IID/OOD gap from the two AUCs.

The carry is a dict of torch tensors on the engine's device, O(n) per
experiment (leaves ``(E, ...)`` for a sweep), and the update runs there
without reading anything back: a round's ``do_eval`` and index are host
values, the accumulators never leave the device until ``finalize``.  The
digests (:func:`analytics_summary`, :func:`participation_summary`,
:func:`quarantine_summary`) are host numpy over finalized rows.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core.propagation import NO_ARRIVAL, arrival_by_hop, hops_from

__all__ = ["AnalyticsSpec", "analytics_summary", "participation_summary",
           "quarantine_summary", "NO_ARRIVAL"]


@dataclasses.dataclass(frozen=True)
class AnalyticsSpec:
    """Configuration of the streaming accumulators: the accuracy level
    that counts as "knowledge arrived" (applied to the IID and the OOD
    curve)."""

    arrival_threshold: float = 0.5

    def init(self, n: int, device="cpu") -> Dict[str, torch.Tensor]:
        """A fresh carry for one experiment of n nodes."""
        return self.init_batch(None, n, device)

    def init_batch(self, n_experiments: Optional[int], n: int,
                   device="cpu") -> Dict[str, torch.Tensor]:
        """A fresh carry with a leading experiment axis (leaves ``(E,
        ...)``; ``None``: no such axis)."""
        lead = () if n_experiments is None else (int(n_experiments),)

        def z(shape, dtype=torch.float32):
            return torch.zeros(lead + shape, dtype=dtype, device=device)

        never = torch.full(lead + (n,), NO_ARRIVAL, dtype=torch.int32,
                           device=device)
        return {
            "count": z((), torch.int32),   # eval rounds folded in so far
            "first_round": z(()),          # round of the first eval
            "prev_round": z(()),           # round of the latest eval
            "prev_iid": z((n,)),           # latest per-node accuracies
            "prev_ood": z((n,)),
            "iid_auc_sum": z((n,)),        # running trapezoid sums
            "ood_auc_sum": z((n,)),
            "iid_arrival": never,
            "ood_arrival": never.clone(),
        }

    def update(self, carry, round_idx: int, do_eval: bool,
               iid: torch.Tensor, ood: torch.Tensor):
        """Fold one round's eval into the carry.  ``round_idx`` is the
        ABSOLUTE round (chunk boundaries cannot shift the stream); a round
        without eval leaves the carry as it is."""
        if not do_eval:
            return carry
        r = float(np.float32(round_idx))
        seen = carry["count"] > 0
        # the trapezoid step needs an earlier eval round
        w = torch.where(seen, 0.5 * (r - carry["prev_round"]),
                        torch.zeros_like(carry["prev_round"]))[..., None]

        def arrive(arr, acc):
            return torch.where((arr == NO_ARRIVAL)
                               & (acc >= self.arrival_threshold),
                               torch.full_like(arr, int(round_idx)), arr)

        return {
            "count": carry["count"] + 1,
            "first_round": torch.where(seen, carry["first_round"],
                                       torch.full_like(
                                           carry["first_round"], r)),
            "prev_round": torch.full_like(carry["prev_round"], r),
            "prev_iid": iid.to(torch.float32),
            "prev_ood": ood.to(torch.float32),
            "iid_auc_sum": carry["iid_auc_sum"] + w * (iid
                                                       + carry["prev_iid"]),
            "ood_auc_sum": carry["ood_auc_sum"] + w * (ood
                                                       + carry["prev_ood"]),
            "iid_arrival": arrive(carry["iid_arrival"], iid),
            "ood_arrival": arrive(carry["ood_arrival"], ood),
        }

    def finalize(self, carry) -> Dict[str, torch.Tensor]:
        """Carry → per-node summaries; the AUCs are normalised by the eval
        span as ``propagation.per_node_auc`` (one eval round: that
        round's accuracy)."""
        span = carry["prev_round"] - carry["first_round"]
        denom = torch.where(span > 0, span, torch.ones_like(span))[..., None]
        multi = (carry["count"] > 1)[..., None]
        iid_auc = torch.where(multi, carry["iid_auc_sum"] / denom,
                              carry["prev_iid"])
        ood_auc = torch.where(multi, carry["ood_auc_sum"] / denom,
                              carry["prev_ood"])
        return {
            "iid_auc": iid_auc,
            "ood_auc": ood_auc,
            "gap_pct": 100.0 * (ood_auc - iid_auc)
            / torch.clamp(iid_auc, min=1e-9),
            "iid_arrival": carry["iid_arrival"],
            "ood_arrival": carry["ood_arrival"],
            "final_iid_acc": carry["prev_iid"],
            "final_ood_acc": carry["prev_ood"],
        }


# ----------------------------------------------------------------------
# host digests of one experiment's finalized rows
# ----------------------------------------------------------------------
def analytics_summary(stream: Dict[str, np.ndarray],
                      adjacency: Optional[np.ndarray] = None,
                      sources: Union[int, Sequence[int], None] = None
                      ) -> Dict[str, object]:
    """Topology-mean AUCs, the mean-based gap (as
    ``propagation.iid_ood_gap``), arrival statistics and, given the
    adjacency and the OOD source(s), the mean arrival round by hop
    distance.  Nodes that never arrive count under ``n_no_arrival``."""
    iid = float(np.mean(stream["iid_auc"]))
    ood = float(np.mean(stream["ood_auc"]))
    arr = np.asarray(stream["ood_arrival"])
    arrived = arr != NO_ARRIVAL
    out: Dict[str, object] = {
        "iid_auc": iid,
        "ood_auc": ood,
        "iid_ood_gap_pct": 100.0 * (ood - iid) / max(iid, 1e-9),
        "ood_arrival_mean": (float(arr[arrived].mean())
                             if arrived.any() else None),
        "n_no_arrival": int((~arrived).sum()),
    }
    if adjacency is not None and sources is not None:
        out["ood_arrival_by_hop"] = arrival_by_hop(
            arr, hops_from(adjacency, sources))
    return out


def participation_summary(part: Dict[str, np.ndarray], rounds: int,
                          stream: Optional[Dict[str, np.ndarray]] = None
                          ) -> Dict[str, object]:
    """One experiment's participation counters: realised activity,
    staleness, local steps and, with its analytics ``stream``, the
    staleness × arrival interaction among the nodes that arrived (the
    Pearson correlation, ``None`` on a degenerate spread, and the mean
    arrival on each side of the median staleness)."""
    ra = np.asarray(part["rounds_active"], np.float64)
    ms = np.asarray(part["mean_staleness"], np.float64)
    out: Dict[str, object] = {
        "activity_rate": float(ra.mean() / max(rounds, 1)),
        "min_rounds_active": int(ra.min()),
        "mean_staleness": float(ms.mean()),
        "max_final_staleness": int(np.max(part["final_staleness"])),
        "local_steps_total": int(np.sum(part["local_steps"])),
    }
    if stream is None:
        return out
    arr = np.asarray(stream["ood_arrival"], np.float64)
    arrived = arr != NO_ARRIVAL
    out["n_no_arrival"] = int((~arrived).sum())
    corr = None
    if arrived.sum() >= 2:
        x, y = ms[arrived], arr[arrived]
        if x.std() > 0 and y.std() > 0:
            corr = float(np.corrcoef(x, y)[0, 1])
    out["staleness_arrival_corr"] = corr
    med = float(np.median(ms))
    lo = arrived & (ms <= med)
    hi = arrived & (ms > med)
    out["arrival_low_staleness"] = float(arr[lo].mean()) if lo.any() else None
    out["arrival_high_staleness"] = (float(arr[hi].mean())
                                     if hi.any() else None)
    return out


def quarantine_summary(fault: Dict[str, np.ndarray],
                       rounds: int) -> Dict[str, object]:
    """One experiment's fault and quarantine counters: how much corruption
    landed, how long nodes sat in quarantine, the detection lag (first
    quarantine − first fault over the nodes caught; ``None`` when none
    was), the faulted nodes never caught, and the false-positive rate —
    quarantined node-rounds of the never-faulty nodes (``None`` when every
    node was faulted)."""
    fr = np.asarray(fault["fault_rounds"], np.int64)
    rq = np.asarray(fault["rounds_quarantined"], np.int64)
    ff = np.asarray(fault["first_fault"], np.int64)
    fq = np.asarray(fault["first_quar"], np.int64)
    n = fr.shape[0]
    faulted = fr > 0
    out: Dict[str, object] = {
        "n_faulty_nodes": int(faulted.sum()),
        "fault_round_rate": float(fr.sum() / max(rounds * n, 1)),
        "rounds_quarantined_mean": float(rq.mean()),
        "rounds_quarantined_max": int(rq.max()),
    }
    caught = faulted & (fq >= 0) & (ff >= 0)
    out["detection_lag_mean"] = (float((fq - ff)[caught].mean())
                                 if caught.any() else None)
    out["n_undetected"] = int((faulted & (fq < 0)).sum())
    clean = ~faulted
    out["false_positive_rate"] = (
        float(rq[clean].sum() / max(rounds * int(clean.sum()), 1))
        if clean.any() else None)
    return out
