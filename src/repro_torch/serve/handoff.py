"""Preemption handoff (port of `repro.serve.handoff`): the scheduler and
request state one engine checkpoints at drain, so that a successor engine
continues token-identically.

What rides the handoff, and why it is enough for bitwise identity:

* every *waiting* request (the prefill, prefix-hit and stream lanes):
  re-queued as it is;
* every *in-flight, unfinished* request with its progress so far: the
  successor re-runs it from the ORIGINAL prompt with its full token budget.
  Greedy decoding under a bitwise `ExecutionPolicy` is deterministic and
  row-independent, so the replay reproduces the predecessor's tokens; the
  recorded progress is the ledger the successor holds its replay to
  (`Engine._finish`).  Re-prefilling the original prompt is the only splice
  that is bitwise safe: prefill(prompt + generated) need not equal
  prefill(prompt) + decode steps bit for bit, so no cache is handed over;
* every *finished* result, as data, preloaded into the successor's result
  map;
* the radix prefix index's published prompts (keys only: the pages are
  device state, rebuilt at the successor's first cold serve;
  `Engine.handoff_prefix_keys` makes them visible).

Storage is the port's `ckpt/checkpoint.py` (atomic rename, a manifest and
one .npy per array) with a ``handoff.json`` sidecar for the per-request
scalars, so a crash mid-save never corrupts an existing handoff.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import restore_checkpoint, save_checkpoint

_STEP = 0  # a handoff directory holds exactly one checkpoint
STATES = ("waiting", "inflight", "finished")


@dataclass
class HandoffRequest:
    """One request's portable state: ``state`` is where it was at drain,
    ``"waiting"`` (never admitted), ``"inflight"`` (admitted, unfinished;
    ``generated`` holds its progress) or ``"finished"`` (``generated`` is the
    whole output)."""

    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    state: str                      # waiting | inflight | finished
    generated: np.ndarray = field(
        default_factory=lambda: np.zeros((0,), np.int32))
    finish_reason: str | None = None
    prefix_hit: bool = False


@dataclass
class Handoff:
    """Everything a successor `Engine.resume` needs, and its bookkeeping."""

    requests: list[HandoffRequest]
    prefix_keys: list[np.ndarray] = field(default_factory=list)
    meta: dict = field(default_factory=dict)

    @property
    def max_rid(self) -> int:
        return max((r.rid for r in self.requests), default=-1)

    def counts(self) -> dict:
        c = dict.fromkeys(STATES, 0)
        for r in self.requests:
            c[r.state] += 1
        c["prefix_keys"] = len(self.prefix_keys)
        c["tokens_in_flight"] = sum(
            len(r.generated) for r in self.requests if r.state == "inflight")
        return c

    # -- persistence ---------------------------------------------------------
    def save(self, directory: str) -> str:
        """Write the handoff under ``directory`` (atomic, as
        `ckpt.checkpoint.save_checkpoint`); returns the checkpoint path."""
        arrays: dict[str, torch.Tensor] = {}
        for r in self.requests:
            arrays[f"req_{r.rid:08d}_prompt"] = _tensor(r.prompt)
            arrays[f"req_{r.rid:08d}_gen"] = _tensor(r.generated)
        for i, k in enumerate(self.prefix_keys):
            arrays[f"prefix_{i:06d}"] = _tensor(k)
        os.makedirs(directory, exist_ok=True)
        sidecar = {
            "version": 1,
            "meta": self.meta,
            "n_prefix_keys": len(self.prefix_keys),
            "requests": [
                {"rid": r.rid, "max_new_tokens": r.max_new_tokens,
                 "state": r.state, "finish_reason": r.finish_reason,
                 "prefix_hit": r.prefix_hit}
                for r in self.requests
            ],
        }
        path = save_checkpoint(directory, _STEP, arrays, keep=1)
        with open(os.path.join(directory, "handoff.json"), "w") as f:
            json.dump(sidecar, f)
        return path

    @classmethod
    def load(cls, directory: str) -> "Handoff":
        with open(os.path.join(directory, "handoff.json")) as f:
            sidecar = json.load(f)
        with open(os.path.join(directory, f"step_{_STEP}",
                               "manifest.json")) as f:
            manifest = json.load(f)
        shapes = {m["path"]: tuple(m["shape"]) for m in manifest["leaves"]}
        reqs = sidecar["requests"]
        keys = ([f"req_{r['rid']:08d}_{part}" for r in reqs
                 for part in ("prompt", "gen")]
                + [f"prefix_{i:06d}" for i in range(sidecar["n_prefix_keys"])])
        if sorted(keys) != sorted(shapes):
            raise ValueError(
                f"handoff sidecar lists {len(keys)} arrays, the checkpoint "
                f"holds {len(shapes)}")
        like = {k: torch.zeros(shapes[k], dtype=torch.int32) for k in keys}
        arrays = {k: v.numpy()
                  for k, v in restore_checkpoint(directory, _STEP, like).items()}
        requests = [
            HandoffRequest(
                rid=r["rid"], prompt=arrays[f"req_{r['rid']:08d}_prompt"],
                max_new_tokens=r["max_new_tokens"], state=r["state"],
                generated=arrays[f"req_{r['rid']:08d}_gen"],
                finish_reason=r["finish_reason"], prefix_hit=r["prefix_hit"])
            for r in reqs
        ]
        prefix_keys = [arrays[f"prefix_{i:06d}"]
                       for i in range(sidecar["n_prefix_keys"])]
        return cls(requests=requests, prefix_keys=prefix_keys,
                   meta=sidecar["meta"])


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.int32).reshape(-1))


def capture_handoff(engine, drained, inflight) -> Handoff:
    """Assemble a `Handoff` from a drained engine: ``drained`` is the
    scheduler's popped (request, ticket) pairs, ``inflight`` the
    `RequestState`s of admitted, unfinished requests (their cohorts are torn
    down by `Engine.drain`)."""
    requests: list[HandoffRequest] = []
    for req, ticket in drained:
        requests.append(HandoffRequest(
            rid=req.rid, prompt=req.prompt,
            max_new_tokens=req.max_new_tokens, state="waiting",
            prefix_hit=bool(ticket is not None and ticket.prefix_hit)))
    for st in inflight:
        requests.append(HandoffRequest(
            rid=st.rid, prompt=st.request.prompt,
            max_new_tokens=st.request.max_new_tokens, state="inflight",
            generated=np.asarray(st.generated, np.int32)))
    for rid, st in engine.results.items():
        requests.append(HandoffRequest(
            rid=rid, prompt=st.request.prompt,
            max_new_tokens=st.request.max_new_tokens, state="finished",
            generated=np.asarray(st.generated, np.int32),
            finish_reason=st.finish_reason))
    requests.sort(key=lambda r: r.rid)
    prefix_keys = (
        [np.asarray(e.prompt, np.int32)
         for e in engine.prefix_index.entries if e.alive]
        if engine.prefix_index is not None else [])
    meta = {
        "policy": engine.policy.describe(),
        "max_len": engine.max_len,
        "max_slots": engine.scheduler.max_slots,
        "max_queue": engine.scheduler.max_queue,
        "bucket_align": engine.scheduler.bucket_align,
        "eos_id": engine.eos_id,
        "arch": engine.cfg.name,
    }
    return Handoff(requests=requests, prefix_keys=prefix_keys, meta=meta)
