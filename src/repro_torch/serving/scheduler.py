"""Continuous-batching scheduler for per-node serving (port of
``repro/serving/scheduler.py``).

Requests arrive with different prompt lengths and stop at different
times.  The scheduler keeps each node's decode batch full by packing
active requests into a fixed set of slots, admitting queued requests into
freed slots between steps, and evicting on EOS/max-length — continuous
batching on top of the serving steps.

Host-side state (queues, slot maps: :class:`Request`, ``_SlotBook``) is
numpy, copied from the reference; device state is the stacked cache.
Admission resets a slot's cache column (position ← 0, and every state
leaf ← 0: the ``ssm`` family's recurrent state and token-shift carries,
the hybrid family's Mamba state and conv inputs;
``serve_step.reset_slots``) and feeds the prompt through chunked prefill
(``make_prefill_step``): one call advances up to ``prefill_chunk`` prompt
tokens.  The reference resets only ``position``, so there a re-used slot
of an RWKV or a hybrid model starts from the previous request's state
(ROADMAP Queue 3).  The legacy token-by-token replay
stays behind ``prefill_chunk=None`` as the bit-equality reference.

:class:`FleetScheduler` holds the whole fleet as ONE ``(n, P)`` parameter
plane plus a node-stacked cache, and advances every node's slots in one
fleet step (``make_fleet_prefill_step``) instead of a Python loop over
nodes.  :meth:`FleetScheduler.swap_node` installs a node's new params by
writing its plane row in place; the next step reads them.  The
reference's retrace counters (``decode_traces``, ``prefill_traces``)
count jit compilations, which eager PyTorch does not have; the port
drops them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.decentralized import unstack_params
from repro_torch.core.plane import PlaneLayout
from repro_torch.models.transformer import (
    add_node_axis,
    decode_step,
    drop_node_axis,
    init_cache,
)
from repro_torch.serving.serve_step import (
    make_cache,
    make_fleet_prefill_step,
    make_prefill_step,
    reset_slots,
)

__all__ = ["Request", "NodeScheduler", "FleetScheduler"]


def _device_of(params) -> torch.device:
    return params["embed"].device


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int = 32
    eos: Optional[int] = None
    # filled by the scheduler:
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class _SlotBook:
    """Host-side slot bookkeeping for one node — no device state.

    Shared by :class:`NodeScheduler` (one book, one node's steps) and
    :class:`FleetScheduler` (n books, one fleet-wide step): the book plans
    token batches and consumes sampled tokens; the owner decides how the
    plans are executed.
    """

    def __init__(self, n_slots: int):
        self.n_slots = n_slots
        self.slots: List[Optional[Request]] = [None] * n_slots
        self.queue: List[Request] = []
        self._pending: Dict[int, List[int]] = {}  # slot → tokens to feed
        self._last = np.zeros(n_slots, np.int64)
        self._count = np.zeros(n_slots, np.int64)  # tokens fed since admit

    def submit(self, req: Request):
        self.queue.append(req)

    @property
    def active(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    @property
    def has_pending(self) -> bool:
        return bool(self._pending)

    def admit(self) -> List[int]:
        """Fill free slots from the queue; returns newly admitted slot
        indices (their cache columns must be reset by the owner)."""
        fresh = []
        for i in range(self.n_slots):
            if self.slots[i] is None and self.queue:
                req = self.queue.pop(0)
                self.slots[i] = req
                self._pending[i] = list(req.prompt)
                self._last[i] = req.prompt[0]
                self._count[i] = 0
                fresh.append(i)
        return fresh

    # -- continuous step plan (chunked prefill + self-feeding decode) ----
    def plan(self, chunk: int, max_seq: int):
        """Token plan for ONE fused dispatch advancing every active slot.

        Slots mid-prompt feed up to ``chunk`` pending tokens; a slot whose
        prompt completes inside the chunk keeps *generating* through the
        remaining scan steps (the kernel self-feeds its greedy sample);
        slots already decoding feed their last sampled token and self-feed
        up to ``chunk`` new tokens — so no lane idles behind another
        slot's prefill.  Generation is capped host-side by the request's
        remaining ``max_new`` budget and the cache headroom
        (``max_seq - 1`` total fed tokens — the legacy over-length
        eviction boundary), so the kernel never writes past either.

        Returns (toks (B, chunk) int32, feed (B,) int32, lens (B,) int32,
        info {slot: (pend_k, start, gen, lens)}) where consume() takes
        slot i's generated tokens from ``sampled[i, start : start + gen]``.
        """
        toks = np.zeros((self.n_slots, chunk), np.int32)
        feed = np.zeros(self.n_slots, np.int32)
        lens = np.zeros(self.n_slots, np.int32)
        info: Dict[int, tuple] = {}
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            headroom = max_seq - 1 - int(self._count[i])
            if headroom <= 0:
                continue  # at the eviction boundary; evict() fires this step
            remaining = req.max_new - len(req.output)
            pend = self._pending.get(i)
            if pend:
                k = min(chunk, len(pend), headroom)
                toks[i, :k] = pend[:k]
                feed[i] = k
                if k < len(pend):           # prompt continues next chunk
                    lens[i] = k
                    info[i] = (k, 0, 0, k)
                else:                       # completes → generate in-chunk
                    gen = max(min(remaining, chunk - k + 1, headroom - k + 1),
                              1)
                    lens[i] = k + gen - 1
                    info[i] = (k, k - 1, gen, k + gen - 1)
            else:                           # decoding: self-feed from _last
                toks[i, 0] = self._last[i]
                feed[i] = 1
                gen = max(min(remaining, chunk, headroom), 1)
                lens[i] = gen
                info[i] = (0, 0, gen, gen)
        return toks, feed, lens, info

    def consume(self, info: Dict[int, tuple], sampled: np.ndarray):
        """Advance the book by one dispatch's results: pending prompts
        shrink by what was fed; generated tokens (``sampled`` rows, the
        per-step greedy argmax) append to each slot's output, truncated at
        the request's EOS if one shows up mid-chunk."""
        for i, (pend_k, start, gen, fed_total) in info.items():
            self._count[i] += fed_total
            if pend_k:
                pend = self._pending[i]
                del pend[:pend_k]
                if not pend:
                    self._pending.pop(i)
            if gen:
                req = self.slots[i]
                new = [int(t) for t in sampled[i, start:start + gen]]
                if req.eos is not None and req.eos in new:
                    new = new[: new.index(req.eos) + 1]
                req.output.extend(new)
                self._last[i] = req.output[-1]

    # -- legacy token-by-token replay (bit-equality reference) -----------
    def replay_plan(self) -> np.ndarray:
        """(B, 1) batch for the legacy path: prompt tokens still being
        fed, else the last sampled token."""
        toks = np.zeros((self.n_slots, 1), np.int32)
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            pend = self._pending.get(i)
            toks[i, 0] = pend[0] if pend else self._last[i]
        return toks

    def consume_replay(self, nxt: np.ndarray):
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            pend = self._pending.get(i)
            if pend:
                pend.pop(0)              # still prefill-feeding this slot
                if not pend:
                    self._pending.pop(i, None)
                    req.output.append(int(nxt[i]))
                    self._last[i] = int(nxt[i])
            else:
                req.output.append(int(nxt[i]))
                self._last[i] = int(nxt[i])

    # -- eviction --------------------------------------------------------
    def evict(self, positions: np.ndarray, max_seq: int):
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            hit_eos = req.eos is not None and req.output and req.output[-1] == req.eos
            full = len(req.output) >= req.max_new
            over = int(positions[i]) >= max_seq - 1
            if hit_eos or full or over:
                req.done = True
                self.slots[i] = None
                self._pending.pop(i, None)


class NodeScheduler:
    """Slot manager for ONE node's model (batch dimension = slots).

    ``prefill_chunk`` selects the admission path: an int C admits prompts
    through chunked prefill (⌈L/C⌉ calls per length-L prompt); ``None``
    keeps the legacy token-by-token replay (O(L) decode steps), the
    bit-equality reference for tests.
    """

    def __init__(self, cfg: ModelConfig, params, n_slots: int, max_seq: int,
                 prefill_chunk: Optional[int] = 8):
        self.cfg = cfg
        self.params = params
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.prefill_chunk = prefill_chunk
        self.device = _device_of(params)
        self.cache = init_cache(cfg, n_slots, max_seq, self.device)
        self._prefill = make_prefill_step(cfg)
        self.book = _SlotBook(n_slots)

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        self.book.submit(req)

    @property
    def queue(self) -> List[Request]:
        return self.book.queue

    @property
    def slots(self) -> List[Optional[Request]]:
        return self.book.slots

    @property
    def active(self) -> int:
        return self.book.active

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def _admit(self):
        fresh = self.book.admit()
        if fresh:
            mask = np.zeros((1, self.n_slots), bool)
            mask[0, fresh] = True
            self.cache = drop_node_axis(reset_slots(
                add_node_axis(self.cache), self._tensor(mask)))

    # ------------------------------------------------------------------
    def step(self) -> int:
        """One scheduler step = ONE call advancing every active slot: a
        ``(B, chunk)`` call while any prompt is mid-prefill (decoding
        slots ride along), a ``(B, 1)`` call in the pure-decode steady
        state.  Returns #active slots."""
        self._admit()
        if self.book.active == 0:
            return 0
        if self.prefill_chunk is None:
            # legacy replay: every step is a single-token decode
            toks = self.book.replay_plan()
            logits, self.cache = decode_step(self.params, self.cfg,
                                             self._tensor(toks), self.cache)
            self.book.consume_replay(
                torch.argmax(logits[:, -1], dim=-1).cpu().numpy())
        else:
            chunk = self.prefill_chunk if self.book.has_pending else 1
            toks, feed, lens, info = self.book.plan(chunk, self.max_seq)
            _, sampled, self.cache = self._prefill(
                self.params, self._tensor(toks), self._tensor(feed),
                self._tensor(lens), self.cache)
            self.book.consume(info, sampled.cpu().numpy())
        self.book.evict(self.cache["position"].cpu().numpy(), self.max_seq)
        return self.book.active

    def run_until_drained(self, max_steps: int = 10_000) -> int:
        steps = 0
        while (self.book.queue or self.book.active) and steps < max_steps:
            self.step()
            steps += 1
        return steps


class FleetScheduler:
    """The whole fleet behind ONE step per scheduler step — the paper's
    deployment (each device serves its own model), plane-fed.

    ``vmapped=True`` packs the stacked params into an ``(n, P)`` plane and
    advances every node's slot batch in one fleet call per step (the
    reference ``vmap``s it; the port's step takes the node axis written
    out); ``vmapped=False`` keeps a Python loop over per-node schedulers
    (n calls per step), the baseline.
    """

    def __init__(self, cfg: ModelConfig, stacked_params, n_nodes: int,
                 n_slots: int, max_seq: int,
                 prefill_chunk: Optional[int] = 8, vmapped: bool = True):
        self.cfg = cfg
        self.n_nodes = n_nodes
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.prefill_chunk = prefill_chunk
        self.vmapped = vmapped
        self._rr = 0
        if not vmapped:
            self.nodes = [NodeScheduler(cfg, p, n_slots, max_seq,
                                        prefill_chunk=prefill_chunk)
                          for p in unstack_params(stacked_params, n_nodes)]
            return
        self.device = _device_of(stacked_params)
        self.layout = PlaneLayout.from_tree(stacked_params)
        self.plane = self.layout.pack(stacked_params)
        self.cache = make_cache(cfg, n_nodes, n_slots, max_seq, self.device)
        self.books = [_SlotBook(n_slots) for _ in range(n_nodes)]
        self._prefill = make_fleet_prefill_step(cfg, self.layout)

    # ------------------------------------------------------------------
    def submit(self, req: Request, node: Optional[int] = None):
        if node is None:
            node = self._rr % self.n_nodes
            self._rr += 1
        if self.vmapped:
            self.books[node].submit(req)
        else:
            self.nodes[node].submit(req)
        return node

    @property
    def active(self) -> int:
        if self.vmapped:
            return sum(b.active for b in self.books)
        return sum(nd.active for nd in self.nodes)

    @property
    def queued(self) -> int:
        books = self.books if self.vmapped else [nd.book for nd in self.nodes]
        return sum(len(b.queue) for b in books)

    def swap_node(self, node: int, params_one):
        """Install one node's freshly gossip-mixed params: its plane row is
        overwritten in place (the plane's storage and every view of it
        stay valid) and the next step reads them.  The leaves are written
        straight into the row: no row-sized temporary (21 GB a node for
        deepseek-v2 cut to 2 layers in its f32 plane)."""
        if not self.vmapped:
            self.nodes[node].params = params_one
            return
        self.layout.pack_row(params_one, out=self.plane[node])

    # ------------------------------------------------------------------
    def step(self) -> int:
        """Advance every node one scheduler step.  Vmapped mode: ONE fleet
        call per step — ``(n, B, chunk)`` while any node has prompt tokens
        mid-prefill (decoding slots everywhere ride along), ``(n, B, 1)``
        in the pure-decode steady state.  Returns total active slots."""
        if not self.vmapped:
            return sum(nd.step() for nd in self.nodes)
        fresh = np.zeros((self.n_nodes, self.n_slots), bool)
        for n, b in enumerate(self.books):
            for i in b.admit():
                fresh[n, i] = True
        if fresh.any():
            self.cache = reset_slots(self.cache,
                                     torch.as_tensor(fresh, device=self.device))
        if all(b.active == 0 for b in self.books):
            return 0
        chunk = ((self.prefill_chunk or 1)
                 if any(b.has_pending for b in self.books) else 1)
        toks = np.zeros((self.n_nodes, self.n_slots, chunk), np.int32)
        feed = np.zeros((self.n_nodes, self.n_slots), np.int32)
        lens = np.zeros((self.n_nodes, self.n_slots), np.int32)
        plans = []
        for n, b in enumerate(self.books):
            t, f, l, info = b.plan(chunk, self.max_seq)
            toks[n], feed[n], lens[n] = t, f, l
            plans.append(info)
        dev = lambda a: torch.as_tensor(a, device=self.device)
        _, sampled, self.cache = self._prefill(
            self.plane, dev(toks), dev(feed), dev(lens), self.cache)
        sampled = sampled.cpu().numpy()  # (n, B, chunk)
        for n, b in enumerate(self.books):
            b.consume(plans[n], sampled[n])
        positions = self.cache["position"].cpu().numpy()  # (n, B)
        for n, b in enumerate(self.books):
            b.evict(positions[n], self.max_seq)
        return self.active

    def run_until_drained(self, max_steps: int = 10_000) -> int:
        if not self.vmapped:
            return sum(nd.run_until_drained(max_steps) for nd in self.nodes)
        steps = 0
        while (self.active or self.queued) and steps < max_steps:
            self.step()
            steps += 1
        return steps
