"""Continuous-batching serving engine (port of `repro.serve.engine`: one
device or a (data, model) serve mesh; sync or pipelined execution; dense or
paged cache storage with radix prefix reuse; speculative decoding;
event-stream prompts).

Each `step()` runs the staged executor (`serve/executor.py`) the policy's
``execution`` axis selects:

    admit -> prefill -> merge -> decode -> sample -> encode -> retire

1. waiting requests are admitted in same-length groups; each group runs
   one batched prefill and emits its first token (prefix hits skip the
   prefill: their first token and cache pages come from the radix index);
2. cohorts at the same sequence position merge (continuous batching);
3. every cohort advances one greedy decode step;
4. finished requests retire and free their slots for the next step.

Under ``execution='sync'`` every stage completes on the host in order.
``execution='pipelined'`` keeps the sampled tokens on the device between
decode steps and lands them on the host behind an in-flight window of
``pipeline_depth`` steps; tokens and logits are those of sync, bit for bit.
`step()` still dispatches one decode per cohort, but tokens reach
`RequestState.generated` up to ``pipeline_depth - 1`` steps later;
`run()`/`generate_batch` drain fully, and external steppers that read
``generated`` mid-flight call `flush()` first.

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

``paging='paged'`` stores every cohort's KV rows in the pages of one
`serve.paging.CacheStore`: merge and retire become page-table edits, and a
`RadixPrefixIndex` (on by default where its contract holds) serves a
repeated prompt from the pages its first prefill wrote.

``speculation=draft(policy, k)`` gives each cohort a draft cache of its own
(a second page-table column under paging): a round proposes k tokens with
the draft in one chained dispatch (`dispatch_propose`), the target
verifies all k + 1 positions in one decode, and rejected positions roll
back by `rewind_cache`, host arithmetic on the position plus a device-side
reset of ``kv_pos``.

Prompts need not be complete at submit time: `submit_stream` queues a
`serve.streaming.StreamSession` whose frames are ingested one decode-shaped
chunk at a time as they arrive; generation starts once the stream closes,
with the tokens of the same frames submitted as one prompt.

Preemption: with ``preemption=PreemptionHandler()`` a SIGTERM (or
``trigger()``) closes admission at the next step and `run()` returns;
`drain` runs the live cohorts within a step budget and returns a
`serve.handoff.Handoff`, from which `Engine.resume` builds a successor that
finishes every request token-identically.

Placement (``ExecutionPolicy.placement``): under a serve mesh
(`serve.sharding`) every model call of a cohort runs in ``data`` row
groups when its rows divide the axis (admission pads prefill batches up to
it, and the pipelined executor re-packs a cohort that retirement skews),
each group on its mesh row's lead device with the mesh row installed as
the kernels' serve mesh, so every spiking FFN's join plan and the
unembedding's column blocks run as ``model`` slabs, slab j on logical
device (i, j).  Under a bitwise policy the placement is reduction-free:
tokens and logits equal the single-device serve bit for bit.  Under
``exactness=approximate(tol)`` attention, the MLPs, the MoE experts and
the recurrent blocks also run psum tensor-parallel on the model axis
(`serve.sharding.shard_params`): logits drift from one device within
``tol``, logit traces are captured by default, and ``bucket_align > 1``
may pad ragged prompts to a shared bucket (token 0).  `remesh` re-places
a live engine onto another mesh (plans and TP slabs re-derive from the
base weights; paged caches keep their pages, no page is copied).

The engine runs on the CUDA device unless ``device`` names another one; it
raises when there is no card and no device was named.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.lif import direct_encode
from repro_torch.core.packing import pack_spikes, timestep_popcount
from repro_torch.kernels import ops
from repro_torch.launch.mesh import data_groups, tree_to

from .batching import DenseCacheOps, PackedSpikeCache, spike_sparsity, upload
from .executor import make_executor
from .handoff import capture_handoff
from .metrics import EngineMetrics, RequestMetrics
from .paging import (
    CacheStore,
    PagedCache,
    PagedCacheOps,
    PagedSpikeCache,
    PageLayout,
    RadixPrefixIndex,
    SpikeSlotPool,
    propose_chain,
)
from .policy import ExecutionPolicy, ParityError, Placement
from .scheduler import AdmissionTicket, Request, RequestState, Scheduler
from .sharding import (
    cache_sharding,
    mesh_summary,
    place_cache,
    place_plans,
    place_tokens,
    shard_params,
    shard_vocab,
)


@dataclass
class Cohort:
    """In-flight requests sharing one batched cache: the first
    ``len(slots)`` rows are live requests, ``n_dummy`` alignment rows follow
    and are dropped at the first membership change.  ``cache`` is a dict of
    tensors, or a `PagedCache` under paging.  ``next_tokens`` is the device
    argmax of the last prefill/decode (all rows), None after a membership
    change.  ``pending`` is the pipelined executor's in-flight window:
    decode steps dispatched but not yet landed on the host (always empty
    under sync).

    ``stream`` marks an INGESTING cohort: its prompt is still arriving as
    event frames, so it neither merges nor decodes, and ``pending`` holds
    the one un-emitted step of its last ingested frame (the first generated
    token once the stream closes).  ``draft_cache`` is the speculative
    draft's cache of the cohort's rows, built at its first round from
    host-known history and dropped whenever keeping it would take more than
    a row edit; ``draft_behind = 1`` marks it one position short of the
    target's (a fully accepted round never fed the draft its last
    proposal)."""

    slots: list[RequestState]
    cache: object
    length: int                 # tokens written per row (prompt + generated)
    n_dummy: int = 0
    spikes: PackedSpikeCache | None = None
    next_tokens: torch.Tensor | None = None
    pending: list = field(default_factory=list)
    stream: object | None = None
    draft_cache: object | None = None
    draft_behind: int = 0


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
        bucket_align: int = 1,
        eos_id: int | None = None,
        policy: ExecutionPolicy | None = None,
        capture_logits: bool | None = None,
        logit_trace_window: int | None = None,
        pipeline_depth: int = 2,
        page_pool_rows: int | None = None,   # paging='paged': pool capacity
        prefix_cache: bool | None = None,    # paging='paged': radix index
        preemption=None,                     # ft.preemption.PreemptionHandler
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
        # logit traces are on by default under approximate exactness, where
        # the drift against a bitwise run is the contract `check_parity`
        # bounds
        self.capture_logits = (not self.policy.token_identical
                               if capture_logits is None
                               else bool(capture_logits))
        if logit_trace_window is not None and logit_trace_window < 1:
            raise ValueError(
                f"logit_trace_window must be >= 1 (got {logit_trace_window});"
                " use None for unbounded capture"
            )
        # keeps each request's most recent W rows (bounded telemetry on long
        # serves; parity checks need the unbounded default)
        self.logit_trace_window = logit_trace_window
        self.logit_traces: dict[int, list[np.ndarray]] = {}
        self.metrics = EngineMetrics()
        # preemption drain (ft/preemption.py): once the handler's
        # should_stop flips, the next step closes admission and run()
        # returns; the owner calls drain() for the handoff
        self.preemption = preemption
        # resume ledger: rid -> the tokens a predecessor had emitted, held
        # against the replay in _finish (a lost token raises)
        self._resume_expect: dict[int, np.ndarray] = {}
        self.handoff_prefix_keys: list[np.ndarray] = []
        # MoE capacity routing couples the rows of a batch (a token's
        # experts depend on its cohort): such an arch never merges cohorts,
        # pads no prefill batch, and the pipelined executor clamps its
        # window to 1
        self.row_independent = cfg.n_experts == 0
        self.merge_cohorts = self.row_independent
        self._user_batch_align = batch_align
        self.batch_align = batch_align if self.row_independent else 1
        self._axes = model.cache_axes()
        # -- speculative decoding (ExecutionPolicy.speculation) --------------
        # a rejected write rolls back by rewinding the position locals:
        # stale slots stay masked by their kv_pos until overwritten.  That
        # needs caches whose only carry is sequence slots + positions.
        self.speculative = self.policy.speculation.enabled
        if self.speculative:
            stateful = [ax for ax in self._axes.values()
                        if "batch" in ax and "cache_seq" not in ax]
            if stateful:
                raise ValueError(
                    f"{cfg.name} carries non-rewindable per-row cache state "
                    f"(leaf axes {stateful[0]}); speculative rollback cannot "
                    "undo a recurrent update — use speculation='none'"
                )
            if not any(ax == () for ax in self._axes.values()):
                raise ValueError(
                    f"{cfg.name}'s cache has no scalar position local to "
                    "rewind; speculation needs one"
                )
        # -- cache backend (ExecutionPolicy.paging) --------------------------
        self.paged = self.policy.paging.enabled
        self.store = None
        self.prefix_index = None
        self._spike_pool = None
        if self.paged:
            template = model.init_cache(1, max_len, device=self.device)
            self._page_layout = PageLayout(template, self._axes,
                                           self.policy.paging.page_size)
            n_rows = (page_pool_rows if page_pool_rows is not None
                      else (2 * max_slots + 4)
                      * (2 if self.speculative else 1))
            self.store = CacheStore(self._page_layout, n_rows,
                                    device=self.device, metrics=self.metrics)
            self.cache_ops = PagedCacheOps(self.store)
            # prefix reuse needs deterministic tokens (the entry caches the
            # first greedy token), independent rows, exact-length buckets (a
            # bucket-padded row's cache holds pad-token state) and no logit
            # capture (a hit emits its first token with no logits row)
            auto_prefix = (self.policy.token_identical and self.row_independent
                           and bucket_align == 1 and not self.capture_logits)
            if prefix_cache is True and not auto_prefix:
                raise ValueError(
                    "prefix_cache=True needs a bitwise policy with "
                    "independent rows, bucket_align=1 and capture_logits "
                    "off: the hit path re-emits a cached greedy first token "
                    "and skips its prefill (no logits to capture)"
                )
            want_prefix = auto_prefix if prefix_cache is None else prefix_cache
            if want_prefix:
                self.prefix_index = RadixPrefixIndex(self.store)
            if policy.spike_format == "packed":
                self._spike_pool = SpikeSlotPool(cfg.d_model, n_rows,
                                                 device=self.device)
            self._paged_prefill = self._page_layout.make_prefill(
                model, max_len, self.device)
            self._paged_decode = self._page_layout.make_decode(model)
        else:
            if prefix_cache:
                raise ValueError(
                    "prefix_cache=True requires policy.paging='paged'"
                )
            self.cache_ops = DenseCacheOps(self._axes)
        self.scheduler = Scheduler(
            max_slots=max_slots, max_queue=max_queue, max_len=max_len,
            bucket_align=bucket_align, prefix_index=self.prefix_index,
            speculation_slack=(self.policy.speculation.k
                               if self.speculative else 0),
        )
        self.cohorts: list[Cohort] = []
        self.results: dict[int, RequestState] = {}
        self.spiking_packed = policy.spike_format == "packed"
        self.spiking_dual_sparse = policy.weight_sparsity == "dual_sparse"
        self.spiking_mode = "infer" if self.spiking_packed else "train"
        self._last_spike_words: torch.Tensor | None = None
        self._base_params = tree_to(params, self.device)
        self._configure_placement(self.policy)
        self.executor = make_executor(self, self.policy, depth=pipeline_depth)

    def _configure_placement(self, policy: ExecutionPolicy) -> None:
        """(Re)derive everything the placement decides, always from the
        base weights (so `remesh` is idempotent): admission alignment (up
        to the data axis, so fresh cohorts split evenly from their first
        step), the join plans split into the model axis's column slabs and
        dealt out with the vocab's column blocks (`_place`), the params on
        each mesh row's device (`_by_device`), and the draft's params
        beside them."""
        self.policy = policy
        mesh = policy.mesh
        self.mesh = mesh
        if mesh is not None and mesh.lead.type != self.device.type:
            raise ValueError(
                f"the serve mesh's devices are {mesh.lead.type}, the engine "
                f"runs on {self.device}")
        self.batch_align = self._user_batch_align if self.row_independent else 1
        if mesh is not None and self.row_independent:
            self.batch_align = max(self.batch_align, mesh.shape["data"])
        base = self._base_params
        shards = 1 if mesh is None else mesh.shape["model"]
        if mesh is not None and self.store is not None:
            self.store.place(mesh)
        self.params = self._prepare(base, self.spiking_dual_sparse, shards)
        self._params_on = self._by_device(self.params)
        if self.speculative:
            self._configure_draft(base, shards)

    def _prepare(self, base: dict, plans: bool, shards: int) -> dict:
        """``model.prepare`` of ``base``, with join plans (column slabs
        over ``shards`` model shards, placed on the mesh) when ``plans``."""
        params = base
        if plans:
            from repro_torch.models.layers import attach_spiking_ffn_plans

            params = attach_spiking_ffn_plans(params, self.cfg,
                                              model_shards=shards)
        return self._place(self.model.prepare(params))

    def _place(self, params: dict) -> dict:
        """Prepared params on the mesh: the psum-TP weights (under
        approximate exactness, `shard_params`: its placement log becomes
        ``tp_log``), the plans' slabs and the vocab's column blocks dealt
        over the model axis (`place_plans`, `shard_vocab`)."""
        if self.mesh is None:
            self.tp_log = []
            return params
        dims = self.policy.model_sharded_dims()
        params, self.tp_log = shard_params(params, self.mesh, dims, self.cfg,
                                           ffn_tp=not self.spiking_packed)
        return shard_vocab(place_plans(params, self.mesh), self.mesh, dims)

    def _by_device(self, params: dict) -> dict:
        """{physical device: ``params`` there} for the devices the data
        groups run on (one tree per card; the plans' slabs place
        themselves)."""
        out = {self.device if self.mesh is None else self.mesh.lead: params}
        if self.mesh is not None:
            for i in range(self.mesh.shape["data"]):
                dev = self.mesh.physical(i, 0)
                if dev not in out:
                    out[dev] = tree_to(params, dev)
        return out

    def _configure_draft(self, base: dict, shards: int = 1) -> None:
        """The draft policy's params next to the target's: the same tensors
        everywhere but the FFNs, which carry what the draft's policy runs.
        A float draft runs the float surrogate path (``spiking_mode
        'train'``, plans unused); a packed dual-sparse draft runs kernel 3
        on its plans (its own, pruned to ``draft_weight_density``, or the
        target's); a packed dense-weight draft runs kernels 1-2 without
        plans.  An adaptive temporal axis on a plan route rides in each FFN
        as ``ffn_policy``, so kernel 4 gates the draft's planes."""
        from repro_torch.models.layers import (
            attach_spiking_ffn_plans,
            derive_draft_params,
        )

        spec = self.policy.speculation
        d = spec.draft
        if spec.draft_weight_density is not None:
            tree = derive_draft_params(base, self.cfg, spec.draft_weight_density)
            mlps = [lp["mlp"] for lp in attach_spiking_ffn_plans(
                tree, self.cfg, model_shards=shards)["layers"]]
        elif d.weight_sparsity == "dual_sparse" and not self.spiking_dual_sparse:
            mlps = [lp["mlp"] for lp in attach_spiking_ffn_plans(
                base, self.cfg, model_shards=shards)["layers"]]
        else:
            mlps = [lp["mlp"] for lp in self.params["layers"]]
        if d.weight_sparsity != "dual_sparse":
            mlps = [{k: v for k, v in m.items()
                     if k not in ("plan_in", "plan_out")} for m in mlps]
        elif d.temporal.enabled:
            mlps = [dict(m, ffn_policy=d) for m in mlps]
        self.draft_params = self._place(self.model.prepare(dict(
            self.params, layers=[dict(lp, mlp=m) for lp, m
                                 in zip(self.params["layers"], mlps)])))
        self._draft_on = self._by_device(self.draft_params)
        self.draft_mode = "infer" if d.spike_format == "packed" else "train"

    # -- request API --------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int) -> AdmissionTicket:
        """Queue one request; raises `AdmissionError` when it cannot be
        accepted."""
        return self.scheduler.submit(prompt, max_new_tokens)

    def submit_stream(self, session, max_new_tokens: int) -> AdmissionTicket:
        """Queue a `serve.streaming.StreamSession`: a request whose prompt
        arrives as event frames.  It is admitted into a cohort of its own
        once its first window completes; later frames are ingested as they
        land, and generation starts when the stream closes.  Binds the
        session's frame budget to this engine (``max_len -
        max_new_tokens``), so an over-long stream surfaces as
        `streaming.Backpressure`, not a cache overflow."""
        if self.spiking_packed and session.T != self.cfg.spiking_T:
            raise ValueError(
                f"stream session T={session.T} != engine spiking_T="
                f"{self.cfg.spiking_T}; frame words must score against the "
                "policy's temporal axis"
            )
        ticket = self.scheduler.submit_stream(session, max_new_tokens)
        session.max_frames = self.max_len - max_new_tokens
        return ticket

    @property
    def n_active(self) -> int:
        return sum(len(c.slots) for c in self.cohorts)

    @property
    def idle(self) -> bool:
        return not self.cohorts and self.scheduler.queue_depth == 0

    def new_cohort(self, **kw) -> Cohort:
        return Cohort(**kw)

    @property
    def stopping(self) -> bool:
        """True once a preemption notice landed (or `drain` closed
        admission): `run()` returns and the owner should `drain()`."""
        return ((self.preemption is not None and self.preemption.should_stop)
                or self.scheduler.closed)

    def step(self) -> dict:
        """One engine iteration; a free no-op when idle.  A pending
        preemption notice closes admission first."""
        if (self.preemption is not None and self.preemption.should_stop
                and not self.scheduler.closed):
            self.scheduler.close()
        if self.idle:
            return {"active": 0, "queued": 0, "cohorts": 0}
        return self.executor.step()

    def flush(self) -> None:
        """Land every in-flight pipelined step (no-op under sync): after
        this, `RequestState.generated` reflects all dispatched decodes."""
        self.executor.drain()

    def run(self) -> dict[int, np.ndarray]:
        """Drive steps until drained; returns {rid: generated tokens}.
        Returns early, with the results so far, once `stopping` flips (the
        preemption path: the owner then calls `drain()`)."""
        while not self.idle and not self.stopping:
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

    # -- preemption drain / handoff / resume (serve/handoff.py) --------------
    def drain(self, *, step_budget: int | None = None):
        """Preemption drain: close admission, step the live cohorts to
        completion (or for at most ``step_budget`` more steps, the drain
        grace), then tear them down and return the `Handoff` a successor
        resumes from.

        No token is lost: every dispatched pipelined step lands (`flush`)
        before in-flight progress is captured, and a speculative round
        emits only verified tokens, so progress is never half-verified.
        Finished results ride the handoff as data; unfinished and waiting
        requests are replayed by the successor.  A cohort still ingesting a
        stream cannot finish (its stream is open): it hands off best-effort,
        the frames completed so far as the successor request's prompt."""
        self.scheduler.close()
        budget = step_budget
        while (self.cohorts
               and any(c.stream is None for c in self.cohorts)
               and (budget is None or budget > 0)):
            self.step()
            if budget is not None:
                budget -= 1
        self.flush()             # land every in-flight pipelined step
        self.executor.retire()   # requests that finished during the grace
        inflight: list[RequestState] = []
        for cohort in self.cohorts:  # the grace ran out with live requests
            inflight.extend(cohort.slots)
            self.scheduler.release(len(cohort.slots))
            self.release_cohort(cohort)
        self.cohorts = []
        drained = self.scheduler.drain()
        self.metrics.n_drained += len(inflight) + len(drained)
        return capture_handoff(self, drained, inflight)

    @classmethod
    def resume(cls, model, params, handoff, **engine_kwargs) -> "Engine":
        """A successor engine from a drain handoff.

        The geometry (max_len, max_slots, max_queue, bucket_align, eos_id)
        defaults to the predecessor's, from ``handoff.meta``; ``policy`` and
        any override ride ``engine_kwargs``.  Finished results are preloaded
        and not counted again in this engine's metrics; waiting and
        in-flight requests are re-queued under their original rids with
        their whole budgets: a replay that, under a bitwise policy,
        reproduces the predecessor's tokens.  Each
        in-flight request's handed-off progress is held against its replay
        at finish (`_finish`), so a lost token raises."""
        meta = handoff.meta
        for key in ("max_len", "max_slots", "max_queue", "bucket_align",
                    "eos_id"):
            engine_kwargs.setdefault(key, meta[key])
        eng = cls(model, params, **engine_kwargs)
        eng.handoff_prefix_keys = [np.asarray(k, np.int32)
                                   for k in handoff.prefix_keys]
        eng.scheduler.reserve_ids(handoff.max_rid + 1)
        for hr in handoff.requests:
            req = Request(hr.rid, np.asarray(hr.prompt, np.int32),
                          hr.max_new_tokens)
            if hr.state == "finished":
                st = RequestState(req)
                st.generated = [int(t) for t in hr.generated]
                st.finish_reason = hr.finish_reason
                st.first_token_time = st.finish_time = req.submit_time
                eng.results[hr.rid] = st
                continue
            eng.scheduler.restore(req)
            if (hr.state == "inflight" and hr.generated.size
                    and eng.policy.token_identical):
                eng._resume_expect[hr.rid] = np.asarray(hr.generated, np.int32)
        return eng

    # -- elastic re-mesh (ft/elastic.py) -------------------------------------
    def remesh(self, devices=None, *, mesh=None,
               model_parallel: int | None = None) -> dict:
        """Re-plan the serve mesh for a changed device set and re-place the
        LIVE engine on it: params and the plans' column slabs re-derive
        from the base weights through the same rules as construction, dense
        cohort caches move to the new lead device, and paged caches keep
        every page (the pools re-place; tables and refcounts are host
        state): ``n_page_moves`` does not change.  Bitwise policies stay
        token-identical across the re-mesh.

        Pass the surviving ``devices`` (`launch.mesh.LogicalDevice`s,
        planned by `ft.elastic.plan_serve_mesh` at the current model axis,
        or ``model_parallel``), or an explicit ``mesh``.  One usable device
        is the unsharded engine.  Returns the new mesh's summary."""
        if mesh is None and devices is not None:
            from repro_torch.ft.elastic import plan_serve_mesh

            mp = model_parallel
            if mp is None:
                mp = self.mesh.shape["model"] if self.mesh is not None else 1
            mesh = plan_serve_mesh(list(devices), model_parallel=mp)
        elif mesh is None and devices is None:
            raise ValueError("remesh needs devices=... or mesh=...")
        if mesh == self.mesh:
            return {"remeshed": False, **mesh_summary(mesh)}
        import dataclasses

        new_policy = dataclasses.replace(
            self.policy,
            placement=Placement(mesh=mesh,
                                model_dims=self.policy.placement.model_dims),
        ).validate_for(self.cfg)
        # land every deferred device value before the placement flips
        self.flush()
        lead = self.device if mesh is None else mesh.lead
        for cohort in self.cohorts:
            cohort.next_tokens = None  # rebuilt from host state next decode
            self.release_draft(cohort)  # rebuilt from host history
            if self.paged:
                cohort.cache.locals = tree_to(cohort.cache.locals, lead)
            else:
                cohort.cache = tree_to(cohort.cache, lead)
        moves = self.metrics.n_page_moves
        self._configure_placement(new_policy)
        if self.paged and mesh is None:
            self.store.pools = tree_to(self.store.pools, self.device)
            self.store.device = self.device
        if self.metrics.n_page_moves != moves:
            raise AssertionError("remesh must not copy cache pages")
        self.metrics.n_remeshes += 1
        return {"remeshed": True, **mesh_summary(mesh)}

    # -- executor services --------------------------------------------------
    @torch.no_grad()
    def _encode_pack(self, params, tokens: torch.Tensor) -> torch.Tensor:
        """Packed direct-encoded spike words of device tokens (int32, left
        on the device: nothing here waits for it)."""
        x = params["embed"][tokens.long()].float()
        words = pack_spikes(direct_encode(x, self.cfg.spiking_T))
        self.record_timestep_skips(words)
        return words

    def _slot_spikes(self, cohort: Cohort) -> torch.Tensor:
        """`_encode_pack` of each slot's newest host token."""
        toks = upload([st.generated[-1] for st in cohort.slots], torch.long,
                      self.device)
        return self._encode_pack(self.params, toks)

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

    def new_spike_cache(self):
        """Per-cohort packed-spike store matching the cache backend."""
        if self._spike_pool is not None:
            return PagedSpikeCache(self.cfg.spiking_T, self.cfg.d_model,
                                   self._spike_pool)
        return PackedSpikeCache(self.cfg.spiking_T, self.cfg.d_model,
                                device=self.device)

    def _live_cache(self, cohort: Cohort):
        if cohort.n_dummy == 0:
            return cohort.cache
        idx = list(range(len(cohort.slots)))
        cohort.n_dummy = 0
        if cohort.draft_cache is not None:
            # the draft cache holds the target's rows, dummies included
            cohort.draft_cache = self.cache_ops.take(cohort.draft_cache, idx)
        return self.cache_ops.take(cohort.cache, idx)

    # -- placement: the data groups of a model call -------------------------
    def _groups(self, n_rows: int):
        """(mesh row, row slice) of each data group of a cohort call, None
        without a mesh.  Row-coupled archs (MoE) never split."""
        if self.mesh is None:
            return None
        if not self.row_independent:
            return [(0, slice(0, n_rows))]
        return data_groups(self.mesh, n_rows)

    def _dense_call(self, call, trees: dict, tokens: torch.Tensor, cache: dict):
        """``call(params, tokens, cache) -> (out, cache)`` over the cohort's
        data groups: group i runs on its mesh row's lead device with that
        row installed as the kernels' serve mesh, on its own cache rows (a
        view of the cohort's cache on the same device: the model writes
        its k/v rows in place).  Outputs concatenate in row order."""
        groups = self._groups(tokens.shape[0])
        if groups is None:
            return call(trees[self.device], tokens, cache)
        lead = self.mesh.lead
        cache = place_cache(cache, self._axes, self.mesh)
        tokens = place_tokens(tokens, self.mesh)
        data_dim = {}  # each leaf's dim on the data axis, None: replicated
        for k, leaf in cache.items():
            spec = (cache_sharding(leaf, self._axes[k], self.mesh)
                    if isinstance(leaf, torch.Tensor) else ())
            data_dim[k] = spec.index("data") if "data" in spec else None
        outs, parts = [], []
        for i, rows in groups:
            dev = self.mesh.physical(i, 0)
            part = {}
            for k, leaf in cache.items():
                b = data_dim[k]
                if isinstance(leaf, torch.Tensor):
                    if b is not None:
                        leaf = leaf.narrow(b, rows.start, rows.stop - rows.start)
                    leaf = leaf.to(dev)
                part[k] = leaf
            with ops.serve_mesh_scope(self.mesh.row(i)):
                out, new = call(trees[dev], tokens[rows].to(dev), part)
            outs.append(out.to(lead))
            parts.append((part, new))
        merged = {}
        for k in self._axes:
            b = data_dim[k]
            news = [new[k] for _, new in parts]
            if b is None:
                leaf = news[-1]
                merged[k] = leaf.to(lead) if isinstance(leaf, torch.Tensor) else leaf
            elif all(new[k] is part[k] and part[k].device == lead
                     for part, new in parts):
                merged[k] = cache[k]  # written in place through the views
            else:
                merged[k] = torch.cat([x.to(lead) for x in news], dim=b)
        return torch.cat(outs), merged

    def _paged_call(self, fn, trees: dict, tokens: torch.Tensor, tables,
                    *rest):
        """A paged model call ``fn(params, tokens, pools, seq, state,
        *rest) -> (out, locals)`` over the cohort's data groups, each on
        its rows of the page tables (pages are whole-row fragments in the
        pools on the mesh's lead device, written in place).  The locals are
        position-like, equal for every group."""
        groups = self._groups(tokens.shape[0])
        if groups is None:
            return fn(trees[self.device], tokens, self.store.pools, *tables,
                      *rest)
        lead = self.mesh.lead
        tokens = place_tokens(tokens, self.mesh)
        outs, locals_ = [], None
        for i, rows in groups:
            with ops.serve_mesh_scope(self.mesh.row(i)):
                out, locals_ = fn(trees[lead], tokens[rows], self.store.pools,
                                  *(t[rows] for t in tables), *rest)
            outs.append(out)
        return torch.cat(outs), locals_

    # -- model dispatch (cache-backend aware) -------------------------------
    @torch.no_grad()
    def dispatch_prefill(self, tokens: np.ndarray):
        """One batched prefill over host tokens (B, P); returns (device
        logits, cohort cache): a fresh dict of tensors, or a `PagedCache`
        whose freshly allocated pages the prefill wrote in full."""
        return self._prefill(tokens, self._params_on, self.spiking_mode)

    def _prefill(self, tokens: np.ndarray, trees: dict, mode: str):
        tokens_dev = upload(tokens, torch.long, self.device)
        if not self.paged:
            cache = self.model.init_cache(tokens.shape[0], self.max_len,
                                          device=self.device)
            return self._dense_call(
                lambda p, t, c: self.model.prefill(
                    p, {"tokens": t}, c, spiking_mode=mode),
                trees, tokens_dev, cache)
        seq_t, state_t = self.store.alloc_rows(tokens.shape[0])
        cache = PagedCache(self.store, seq_t, state_t, {})
        logits, cache.locals = self._paged_call(
            self._paged_prefill, trees, tokens_dev, cache.tables_dev(), mode)
        return logits, cache

    @torch.no_grad()
    def dispatch_decode(self, tokens: torch.Tensor, cache):
        """One decode step for a cohort; returns (device logits, cache).
        Under paging the step gathers the cohort's pages into a dense view,
        runs the model on it and writes back the pages it touched."""
        if not self.paged:
            return self._dense_call(
                lambda p, t, c: self.model.decode(
                    p, t, c, spiking_mode=self.spiking_mode),
                self._params_on, tokens.long(), cache)
        logits, cache.locals = self._paged_call(
            self._paged_decode, self._params_on, tokens.long(),
            cache.tables_dev(), cache.locals, self.spiking_mode)
        return logits, cache

    # -- speculative dispatch (ExecutionPolicy.speculation) ------------------
    @torch.no_grad()
    def dispatch_propose(self, chunk: torch.Tensor, draft_cache, k: int):
        """Draft-propose ``k`` tokens per row; returns ((B, k) device draft
        tokens, draft cache).  ``chunk`` is the (B, 1) pending token, or
        (B, 2) [last verified, pending] when the draft cache is one behind.
        The ``catchup - 1`` feed positions and the k chained greedy steps
        keep their argmax feedback on the device: nothing here reads it."""
        if not self.paged:
            return self._dense_call(
                lambda p, t, c: propose_chain(self.model, p, t, c, k,
                                              self.draft_mode),
                self._draft_on, chunk, draft_cache)
        fn = self._page_layout.make_propose(self.model, k, chunk.shape[1])
        toks, draft_cache.locals = self._paged_call(
            fn, self._draft_on, chunk, draft_cache.tables_dev(),
            draft_cache.locals, self.draft_mode)
        return toks, draft_cache

    @torch.no_grad()
    def dispatch_draft_prefill(self, tokens: np.ndarray):
        """A draft cache from a prefill of host-known history (B, L) under
        the draft's params and mode; the prefill's logits are not used."""
        self.metrics.n_draft_prefills += 1
        return self._prefill(tokens, self._draft_on, self.draft_mode)[1]

    def rewind_cache(self, cache, steps: int):
        """Roll a cache's positions back by ``steps``: the rejected writes
        of a speculative round.  The host-int position goes back, and every
        ``kv_pos`` slot at or past it returns to -1 (empty) on the device
        (no read); the stale k/v there stay masked until a real write.  The
        locals then equal those of a cohort that never speculated, so
        cohorts with different acceptance histories still merge.  Rewound
        pages need no decref: the row's page set is unchanged."""
        if steps <= 0:
            return cache
        if self.paged:
            cache.locals = self._rewound(cache.locals, steps)
            return cache
        return self._rewound(cache, steps)

    def _rewound(self, leaves: dict, steps: int) -> dict:
        pos_key = next(k for k, ax in self._axes.items() if ax == ())
        new_pos = leaves[pos_key] - steps
        out = {}
        for key, leaf in leaves.items():
            if key == pos_key:
                out[key] = new_pos
            elif self._axes[key] == (None,):
                out[key] = leaf.masked_fill(leaf >= new_pos, -1)
            else:
                out[key] = leaf
        return out

    def release_draft(self, cohort: Cohort) -> None:
        """Drop a cohort's draft cache (paged rows decref'd): always safe,
        it rebuilds from host-known history at the next round."""
        if cohort.draft_cache is not None and self.paged:
            cohort.draft_cache.release()
        cohort.draft_cache = None
        cohort.draft_behind = 0

    # -- prefix reuse -------------------------------------------------------
    def publish_prefix(self, cohort: Cohort) -> None:
        """Publish each just-prefilled row's full prompt into the radix
        index (before any decode writes the row's tail page: the index
        snapshots that page plus the state page and position locals)."""
        if self.prefix_index is None:
            return
        cache = cohort.cache
        for i, st in enumerate(cohort.slots):
            if st.request.prompt_len != cohort.length:
                continue  # bucket-padded row: its cache holds pad tokens
            self.prefix_index.publish(
                st.request.prompt, cache.seq_table[i],
                int(cache.state_table[i]), cache.locals, st.generated[0],
            )

    def admit_prefix_hits(self, group: list) -> None:
        """Admit one same-length prefix-hit group [(Request, PrefixEntry)]
        as a cohort with the shared pages materialized: no prefill runs;
        each request's first token is the entry's cached greedy token.  The
        scheduler's submit-time pins are held through the admit and
        released in the ``finally``."""
        try:
            self._admit_prefix_hits_pinned(group)
        finally:
            self.scheduler.release_hit_pins(group)

    def _admit_prefix_hits_pinned(self, group: list) -> None:
        P = group[0][0].prompt_len
        rows = [self.prefix_index.admit(entry) for _, entry in group]
        seq_t = np.stack([r for r, _ in rows])
        state_t = np.concatenate([s for _, s in rows])
        n_dummy = (-len(group)) % max(1, self.batch_align)
        if n_dummy:
            dseq, dstate = self.store.alloc_rows_zeroed(n_dummy)
            seq_t = np.concatenate([seq_t, dseq], axis=0)
            state_t = np.concatenate([state_t, dstate], axis=0)
            self.metrics.n_padded_rows += n_dummy
        cache = PagedCache(self.store, seq_t, state_t, dict(group[0][1].locals))
        slots = [RequestState(req) for req, _ in group]
        for st, (_, entry) in zip(slots, group):
            st.emit(int(entry.first_token), self.eos_id)
        cohort = self.new_cohort(slots=slots, cache=cache, length=P,
                                 n_dummy=n_dummy)
        if self.spiking_packed:
            cohort.spikes = self.new_spike_cache()
            cohort.spikes.append(self._slot_spikes(cohort))
        self.cohorts.append(cohort)
        self.metrics.n_prefix_hits += len(group)
        self.metrics.n_prefix_tokens_reused += P * len(group)

    def release_cohort(self, cohort: Cohort) -> None:
        """Return a fully retired cohort's storage to the pools (dense
        cohorts are freed with their tensors)."""
        self.release_draft(cohort)
        if self.paged:
            cohort.cache.release()
            if cohort.spikes is not None:
                cohort.spikes.take([])

    def drain_logit_traces(self) -> list[list[np.ndarray]]:
        """Per-request logit traces in rid order, clearing the store (pass
        the result to `serve.policy.check_parity`)."""
        out = [self.logit_traces[r] for r in sorted(self.logit_traces)]
        self.logit_traces = {}
        return out

    def _capture(self, slots: list[RequestState], logits) -> None:
        """Record each live slot's last-position logits (the vector whose
        argmax is the token emitted this step): a device tensor, or host
        values the pipelined executor landed."""
        if not self.capture_logits:
            return
        rows = logits[: len(slots), -1]
        rows = (rows.float().cpu().numpy() if isinstance(rows, torch.Tensor)
                else np.asarray(rows, np.float32))
        w = self.logit_trace_window
        for st, row in zip(slots, rows):
            if st.done:
                # a finished slot riding in a cohort (a pipelined decode
                # past EOS): one trace row per EMITTED token, as under sync
                continue
            trace = self.logit_traces.setdefault(st.rid, [])
            trace.append(row)
            if w is not None and len(trace) > w:
                del trace[: len(trace) - w]

    def _finish(self, st: RequestState) -> None:
        expect = self._resume_expect.pop(st.rid, None)
        if expect is not None:
            # the lost-token gate: the replay must extend the predecessor's
            # handed-off progress exactly (recorded under bitwise policies)
            got = np.asarray(st.generated[: expect.shape[0]], np.int32)
            if not np.array_equal(got, expect):
                raise ParityError(
                    f"resumed request {st.rid} diverged from its handoff "
                    f"progress: replayed {got.tolist()} vs handed-off "
                    f"{expect.tolist()}"
                )
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
        s["admission_closed"] = self.scheduler.closed
        s["device"] = str(self.device)
        s["policy"] = self.policy.describe()
        s["exactness"] = self.policy.exactness.mode
        s["execution"] = self.policy.execution
        s["pipeline_depth"] = getattr(self.executor, "depth", None)
        s["token_identical"] = self.policy.token_identical
        s.update(mesh_summary(self.mesh, self.tp_log))
        if not self.policy.token_identical:
            s["drift_tol"] = self.policy.exactness.tol
        s["paging"] = self.policy.paging.describe()
        if self.paged:
            s["page_pool"] = self.store.summary()
            if self.prefix_index is not None:
                s["prefix_index"] = self.prefix_index.summary()
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
        s["speculation"] = self.policy.speculation.describe()
        return s
