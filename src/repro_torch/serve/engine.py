"""Continuous-batching serving engine (port of `repro.serve.engine`: dense
KV cache, sync executor, one device).

Each `step()` runs the staged executor (`serve/executor.py`):

    admit -> prefill -> merge -> decode -> sample -> encode -> retire

1. waiting requests are admitted in same-length groups; each group runs
   one batched prefill and emits its first token;
2. cohorts at the same sequence position merge (continuous batching);
3. every cohort advances one greedy decode step;
4. finished requests retire and free their slots for the next step.

The `ExecutionPolicy` picks the spiking FFN's execution:
``spike_format='packed'`` runs the model with ``spiking_mode='infer'`` and
keeps a `PackedSpikeCache` of each slot's direct-encoded current token;
``weight_sparsity='dual_sparse'`` attaches per-layer `WeightJoinPlan`s at
construction (host work, once), so both GEMMs of every spiking FFN run
through the dual-sparse BSR kernel; ``weight_sparsity='dense'`` attaches
none, and they run through the dense-weight kernels.  Under
``temporal='adaptive'`` the engine counts, at the encode boundary, the
timestep planes the policy's scorer marks skippable
(``timesteps_skipped``).  As in the reference, the served model's FFNs
still walk every plane: the temporal axis reaches the kernels only
through `kernels.ops.dispatch`.

The engine runs on the CUDA device unless ``device`` names another one; it
raises when there is no card and no device was named.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.lif import direct_encode
from repro_torch.core.packing import pack_spikes, timestep_popcount

from .batching import DenseCacheOps, PackedSpikeCache, spike_sparsity
from .executor import SyncExecutor
from .metrics import EngineMetrics, RequestMetrics
from .policy import ExecutionPolicy
from .scheduler import AdmissionTicket, RequestState, Scheduler


@dataclass
class Cohort:
    """In-flight requests sharing one batched cache: the first
    ``len(slots)`` rows are live requests, ``n_dummy`` alignment rows follow
    and are dropped at the first membership change.  ``next_tokens`` is the
    device argmax of the last prefill/decode (all rows), None after a
    membership change."""

    slots: list[RequestState]
    cache: dict
    length: int                 # tokens written per row (prompt + generated)
    n_dummy: int = 0
    spikes: PackedSpikeCache | None = None
    next_tokens: torch.Tensor | None = None


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)


class Engine:
    def __init__(
        self,
        model,
        params,
        *,
        max_len: int,
        max_slots: int = 8,
        max_queue: int = 256,
        batch_align: int = 1,
        eos_id: int | None = None,
        policy: ExecutionPolicy | None = None,
        capture_logits: bool = False,
        device=None,
    ):
        cfg = model.cfg
        if not cfg.supports_decode or cfg.encoder_only:
            raise ValueError(f"{cfg.name} has no decode path; cannot serve")
        self.device = resolve_device(device)
        policy = ExecutionPolicy() if policy is None else policy
        self.policy = policy.validate_for(cfg)
        self.model = model
        self.cfg = cfg
        self.max_len = max_len
        self.eos_id = eos_id
        self.batch_align = batch_align
        self.capture_logits = capture_logits
        self.logit_traces: dict[int, list[np.ndarray]] = {}
        self.metrics = EngineMetrics()
        self.cache_ops = DenseCacheOps(model.cache_axes())
        self.scheduler = Scheduler(
            max_slots=max_slots, max_queue=max_queue, max_len=max_len,
        )
        self.cohorts: list[Cohort] = []
        self.results: dict[int, RequestState] = {}
        self.spiking_packed = policy.spike_format == "packed"
        self.spiking_dual_sparse = policy.weight_sparsity == "dual_sparse"
        self.spiking_mode = "infer" if self.spiking_packed else "train"
        self._last_spike_words: torch.Tensor | None = None
        params = _to_device(params, self.device)
        if self.spiking_dual_sparse:
            from repro_torch.models.layers import attach_spiking_ffn_plans

            params = attach_spiking_ffn_plans(params, cfg)
        self.params = model.prepare(params)
        self.executor = SyncExecutor(self)

    # -- request API --------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int) -> AdmissionTicket:
        """Queue one request; raises `AdmissionError` when it cannot be
        accepted."""
        return self.scheduler.submit(prompt, max_new_tokens)

    @property
    def n_active(self) -> int:
        return sum(len(c.slots) for c in self.cohorts)

    @property
    def idle(self) -> bool:
        return not self.cohorts and self.scheduler.queue_depth == 0

    def new_cohort(self, **kw) -> Cohort:
        return Cohort(**kw)

    def step(self) -> dict:
        """One engine iteration; a free no-op when idle."""
        if self.idle:
            return {"active": 0, "queued": 0, "cohorts": 0}
        return self.executor.step()

    def run(self) -> dict[int, np.ndarray]:
        """Drive steps until drained; returns {rid: generated tokens}."""
        while not self.idle:
            self.step()
        return {
            rid: np.asarray(st.generated, np.int32)
            for rid, st in sorted(self.results.items())
        }

    def generate_batch(self, prompts, max_new_tokens: int) -> list[np.ndarray]:
        """Submit prompts, drain, return outputs in order."""
        tickets = [self.submit(p, max_new_tokens) for p in prompts]
        out = self.run()
        return [out[t.rid] for t in tickets]

    # -- executor services --------------------------------------------------
    @torch.no_grad()
    def _slot_spikes(self, cohort: Cohort) -> torch.Tensor:
        """Packed direct-encoded spike words of each slot's newest token
        (int32, left on the device: nothing here waits for it)."""
        toks = torch.tensor([st.generated[-1] for st in cohort.slots],
                            dtype=torch.int64, device=self.device)
        x = self.params["embed"][toks].float()
        words = pack_spikes(direct_encode(x, self.cfg.spiking_T))
        self.record_timestep_skips(words)
        return words

    def record_timestep_skips(self, words: torch.Tensor) -> None:
        """Count the timestep planes of one packed batch that the policy's
        temporal scorer marks skippable (``metrics.timesteps_skipped``):
        the reference's rule, kept on the device (no host copy per step)."""
        temporal = self.policy.temporal
        if not temporal.enabled or words.numel() == 0:
            return
        counts = timestep_popcount(words, self.cfg.spiking_T)
        self.metrics.timesteps_skipped = (
            self.metrics.timesteps_skipped
            + (counts < temporal.min_spikes).sum(dtype=torch.int64))

    def new_spike_cache(self) -> PackedSpikeCache:
        return PackedSpikeCache(self.cfg.spiking_T, self.cfg.d_model,
                                device=self.device)

    def _live_cache(self, cohort: Cohort) -> dict:
        if cohort.n_dummy == 0:
            return cohort.cache
        cohort.n_dummy = 0
        return self.cache_ops.take(cohort.cache, list(range(len(cohort.slots))))

    @torch.no_grad()
    def dispatch_prefill(self, tokens: np.ndarray):
        """One batched prefill over host tokens (B, P) into a fresh cache;
        returns (device logits, cache)."""
        cache = self.model.init_cache(tokens.shape[0], self.max_len,
                                      device=self.device)
        batch = {"tokens": torch.as_tensor(tokens, device=self.device).long()}
        return self.model.prefill(self.params, batch, cache,
                                  spiking_mode=self.spiking_mode)

    @torch.no_grad()
    def dispatch_decode(self, tokens: torch.Tensor, cache: dict):
        """One decode step for a cohort; returns (device logits, cache)."""
        return self.model.decode(self.params, tokens.long(), cache,
                                 spiking_mode=self.spiking_mode)

    def drain_logit_traces(self) -> list[list[np.ndarray]]:
        """Per-request logit traces in rid order, clearing the store (pass
        the result to `serve.policy.check_parity`)."""
        out = [self.logit_traces[r] for r in sorted(self.logit_traces)]
        self.logit_traces = {}
        return out

    def _capture(self, slots: list[RequestState], logits) -> None:
        """Record each live slot's last-position logits (the vector whose
        argmax is the token emitted this step)."""
        if not self.capture_logits:
            return
        rows = logits[: len(slots), -1].float().cpu().numpy()
        for st, row in zip(slots, rows):
            if not st.done:
                self.logit_traces.setdefault(st.rid, []).append(row)

    def _finish(self, st: RequestState) -> None:
        self.results[st.rid] = st
        req = st.request
        self.metrics.record(RequestMetrics(
            rid=st.rid,
            prompt_len=req.prompt_len,
            n_generated=len(st.generated),
            ttft_s=st.first_token_time - req.submit_time,
            latency_s=st.finish_time - req.submit_time,
            finish_reason=st.finish_reason,
        ))

    # -- reporting ----------------------------------------------------------
    def summary(self) -> dict:
        s = self.metrics.summary()
        s["rejected"] = self.scheduler.n_rejected
        s["device"] = str(self.device)
        s["policy"] = self.policy.describe()
        s["exactness"] = self.policy.exactness.mode
        s["execution"] = self.policy.execution
        s["token_identical"] = self.policy.token_identical
        if self.spiking_packed:
            words = self._last_spike_words
            s["spike_sparsity"] = (float("nan") if words is None
                                   else spike_sparsity(words, self.cfg.spiking_T))
            s["spike_bytes_packed_per_slot"] = self.cfg.d_model * 4
            s["spike_bytes_unpacked_f32_per_slot"] = (
                self.cfg.d_model * self.cfg.spiking_T * 4
            )
            s["dual_sparse"] = self.spiking_dual_sparse
        s["temporal"] = self.policy.temporal.describe()
        return s
