"""Slot-based continuous-batching serving engine (port of
``repro/serving/engine.py``).

The decode path (``repro_torch.models.transformer.decode_step``) is a
fixed-batch step: caches are ``[period, B, ...]`` tensors. The engine
manages B **slots**:

- incoming requests are queued and admitted into free slots;
- each engine ``step()`` decodes ONE token for the slots at the lowest
  position (inactive slots and slots further on feed a pad token whose
  output is ignored, the usual static-batch trick);
- per-slot position counters drive prompt-feeding (prefill runs through the
  same decode step, token by token) and completion detection;
- finished slots return their output and become free for the next queued
  request, i.e. continuous batching at slot granularity.

Cache isolation between consecutive requests in the same slot comes from
positional masking (ring-buffer slots with ``slot_pos > position`` are
invalid) and from zeroing a slot's rows when a request is admitted.

Unlike the reference, which builds new arrays, the engine updates its cache
IN PLACE: admission zeroes the new slots' rows of every ``[period, B, ...]``
leaf, and after a step the rows of the slots that were not stepped are
copied back from the old cache into the new one.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional

import torch

from repro_torch import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.telemetry import EventLog, RingTimer
from repro_torch.utils.tree import tree_flatten


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]            # token ids
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    # filled on completion:
    output: Optional[List[int]] = None
    # telemetry timestamps (perf_counter seconds; None until reached):
    t_submit: Optional[float] = None
    t_admit: Optional[float] = None


@dataclasses.dataclass
class _Slot:
    req: Optional[Request] = None
    pos: int = 0                 # next absolute position to feed
    generated: Optional[list] = None

    @property
    def active(self) -> bool:
        return self.req is not None


class ServeEngine:
    """``event_log`` (a ``telemetry.EventLog``) receives one ``serve`` event
    with ``stats()`` after every decode step."""

    def __init__(self, cfg, params, batch_slots: int = 4, max_len: int = 256,
                 sample: str = "greedy", event_log: Optional[EventLog] = None,
                 device=None):
        if cfg.n_codebooks:
            raise NotImplementedError("engine currently serves plain-LM archs")
        if sample != "greedy":
            raise ValueError(f"unknown sampling {sample!r}; the engine decodes greedily")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.B = batch_slots
        self.max_len = max_len
        self.sample = sample
        self.cache = tfm.init_cache(cfg, batch_slots, max_len, device=self.device)
        self.slots = [_Slot() for _ in range(batch_slots)]
        self.queue: deque[Request] = deque()
        self.finished: Dict[int, Request] = {}
        # -- telemetry (host-side counters; one ``serve`` event per step)
        self.event_log = event_log
        self.tokens_total = 0
        self.steps_total = 0
        self.step_timer = RingTimer(256)      # decode step wall time
        self.admit_timer = RingTimer(256)     # submit -> slot admission
        self._token_window: deque = deque(maxlen=256)  # (t, n_new) per step

    # ------------------------------------------------------------- plumbing
    def _rows(self, slots: List[int]) -> torch.Tensor:
        return torch.tensor(slots, dtype=torch.long, device=self.device)

    def submit(self, req: Request) -> None:
        req.t_submit = time.perf_counter()
        self.queue.append(req)

    def _admit(self) -> None:
        newly = []
        for i, slot in enumerate(self.slots):
            if not slot.active and self.queue:
                req = self.queue.popleft()
                if len(req.prompt) + req.max_new_tokens > self.max_len:
                    raise ValueError(f"request {req.uid} exceeds engine max_len {self.max_len}")
                req.t_admit = time.perf_counter()
                if req.t_submit is not None:
                    self.admit_timer.record(req.t_admit - req.t_submit)
                self.slots[i] = _Slot(req=req, pos=0, generated=[])
                newly.append(i)
        if newly:
            # zero the new slots' rows (leaf: [period, B, ...]), in place
            rows = self._rows(newly)
            for leaf in tree_flatten(self.cache)[0]:
                leaf[:, rows] = 0

    # ----------------------------------------------------------------- step
    def step(self) -> None:
        """Admit queued requests and decode one token for the slots at the
        lowest position."""
        self._admit()
        if not any(s.active for s in self.slots):
            return

        # Slots can be at different positions; the step takes ONE position,
        # so we step the minimum-position cohort. The other slots feed a pad
        # token, and their cache rows are restored after the step.
        pos = min(s.pos for s in self.slots if s.active)

        toks = []
        stepped = []
        for s in self.slots:
            if s.active and s.pos == pos:
                req = s.req
                if s.pos < len(req.prompt):
                    toks.append(req.prompt[s.pos])
                else:
                    toks.append(s.generated[-1])
                stepped.append(True)
            else:
                toks.append(0)
                stepped.append(False)

        self.step_timer.start()
        logits, new_cache = tfm.decode_step(
            self.params, self.cfg, self.cache,
            torch.tensor(toks, dtype=torch.long, device=self.device), pos)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)  # honest step timing (async launches)
        self.step_timer.stop()
        self.steps_total += 1

        # non-stepped slots must keep their cache rows (they were written at
        # `pos` with garbage): copy them back from the old cache, in place
        kept = [i for i, s in enumerate(stepped) if not s]
        if kept:
            rows = self._rows(kept)
            for new, old in zip(tree_flatten(new_cache)[0], tree_flatten(self.cache)[0]):
                new[:, rows] = old[:, rows]
        self.cache = new_cache

        nxt = torch.argmax(logits, dim=-1).tolist()  # greedy
        n_new = 0
        for i, s in enumerate(self.slots):
            if not (s.active and stepped[i]):
                continue
            s.pos += 1
            req = s.req
            if s.pos >= len(req.prompt):  # we just consumed prompt/gen token
                tok = int(nxt[i])
                s.generated.append(tok)
                n_new += 1
                done = (len(s.generated) >= req.max_new_tokens
                        or (req.eos_id is not None and tok == req.eos_id))
                if done:
                    req.output = list(s.generated[:req.max_new_tokens])
                    self.finished[req.uid] = req
                    self.slots[i] = _Slot()
        self.tokens_total += n_new
        self._token_window.append((time.perf_counter(), n_new))
        if self.event_log is not None:
            self.event_log.serve(self.stats())

    # ------------------------------------------------------------ telemetry
    def stats(self) -> Dict[str, float]:
        """Current engine metrics snapshot (names from the reference's
        telemetry catalogue: queue depth, active slots, latency, tokens/s)."""
        out: Dict[str, float] = {
            "serve_queue_depth": len(self.queue),
            "serve_active_slots": sum(s.active for s in self.slots),
            "serve_tokens_total": self.tokens_total,
            "serve_steps_total": self.steps_total,
        }
        if len(self.step_timer):
            out["serve_decode_step_s"] = self.step_timer.summary()["mean_s"]
        if len(self.admit_timer):
            out["serve_admit_latency_s"] = self.admit_timer.summary()["mean_s"]
        if len(self._token_window) >= 2:
            t0, _ = self._token_window[0]
            t1, _ = self._token_window[-1]
            if t1 > t0:
                # tokens after the window's first timestamp, over its span
                n = sum(k for _, k in list(self._token_window)[1:])
                out["serve_tokens_per_s"] = n / (t1 - t0)
        return out

    def run_until_drained(self, max_steps: int = 10_000) -> Dict[int, Request]:
        for _ in range(max_steps):
            if not self.queue and not any(s.active for s in self.slots):
                break
            self.step()
        return self.finished
