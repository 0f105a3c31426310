"""`ExecutionPolicy`: one declarative serve/kernel execution policy (port of
`repro.serve.policy`).

Axes: ``spike_format`` (float | packed), ``weight_sparsity``
(dense | dual_sparse), ``exactness`` (bitwise | approximate(tol)),
``execution`` (sync | pipelined),
``paging`` (none | paged(page_size)), ``temporal``
(full | adaptive(min_spikes)) and ``speculation`` (none | draft(policy, k):
a cheaper draft policy over the same weights proposes k tokens a round, the
target verifies all k + 1 positions in one decode) and ``placement`` (a
(data, model) serve mesh of logical devices, `serve.sharding`: under the
reduction-free rules of a bitwise policy, or, under
``exactness=approximate(tol)``, psum tensor parallelism of attention, the
MLPs, the MoE experts and the recurrent blocks on the model axis).
Approximate exactness needs one of its two sources of approximation: a
model axis >= 2 (psum-TP) or lossy temporal skipping; without either it
raises `ValueError`, as in the reference.

Also here, as in the reference: `acceptance_lengths` (the speculative
round's longest verified prefix), and `check_parity`, `max_logit_drift`
and `drift_report`, the assertion and the measurement of a policy's
exactness contract between a reference run and a policy run.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

SPIKE_FORMATS = ("float", "packed")
WEIGHT_SPARSITIES = ("dense", "dual_sparse")
EXACTNESS_MODES = ("bitwise", "approximate")
TEMPORAL_MODES = ("full", "adaptive")
EXECUTION_MODES = ("sync", "pipelined")
PAGING_MODES = ("none", "paged")
SPECULATION_MODES = ("none", "draft")


# ---------------------------------------------------------------------------
# policy axes
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Exactness:
    """The output contract of a serving run.

    ``bitwise``: outputs are token-identical to the reference loop.
    ``approximate``: greedy tokens may flip, but logit drift against the
    bitwise reference is bounded by ``tol`` (asserted by `check_parity`)."""

    mode: str = "bitwise"
    tol: float = 0.0  # max |logit drift| allowed (approximate mode only)

    def __post_init__(self):
        if self.mode not in EXACTNESS_MODES:
            raise ValueError(
                f"exactness mode {self.mode!r} not in {EXACTNESS_MODES}"
            )
        if self.mode == "approximate" and not self.tol > 0.0:
            raise ValueError(
                "exactness='approximate' needs a positive drift bound: "
                f"tol={self.tol!r} (use exactness.approximate(tol=...))"
            )
        if self.mode == "bitwise" and self.tol:
            raise ValueError(
                "exactness='bitwise' is token-identical by definition; "
                f"tol={self.tol!r} is meaningless — drop it or use "
                "approximate(tol)"
            )


def bitwise() -> Exactness:
    """Token-identity contract (the default)."""
    return Exactness("bitwise")


def approximate(tol: float = 0.05) -> Exactness:
    """Relaxed contract: logit drift <= tol instead of token identity."""
    return Exactness("approximate", tol)


@dataclass(frozen=True)
class Placement:
    """Where a policy runs: a (data, model) serve mesh (`launch.mesh.Mesh`,
    or None = one device) and the logical weight dims placed on its model
    axis.  ``model_dims`` None derives them from the exactness
    (`serve.sharding.MODEL_SHARDED_DIMS` under bitwise); an explicit tuple
    overrides and is checked against the exactness contract."""

    mesh: object | None = None
    model_dims: tuple[str, ...] | None = None

    def __post_init__(self):
        if self.model_dims is not None:
            object.__setattr__(self, "model_dims", tuple(self.model_dims))

    @classmethod
    def from_spec(cls, spec: str | None, *, devices=None, device=None,
                  model_dims=None) -> "Placement":
        """From a ``--mesh`` spec (``data,model``, ``data=4,model=2``,
        ``4,2``) over ``devices`` (default: the logical devices on
        ``device``); None or one device = no mesh."""
        from .sharding import make_serve_mesh

        return cls(mesh=make_serve_mesh(spec, devices=devices, device=device),
                   model_dims=model_dims)

    @property
    def data_size(self) -> int:
        return self.mesh.shape["data"] if self.mesh is not None else 1

    @property
    def model_size(self) -> int:
        return self.mesh.shape["model"] if self.mesh is not None else 1

    def describe(self) -> str:
        if self.mesh is None:
            return "single-device"
        return self.mesh.describe()


@dataclass(frozen=True)
class Temporal:
    """The third sparsity axis: which timesteps the FTP kernels walk.

    ``"full"``: every timestep plane of the packed payload is contracted.
    ``"adaptive"``: a device-side scorer
    (`core.packing.timestep_activity_map`) popcounts each timestep plane;
    planes carrying fewer than ``min_spikes`` spikes in total add nothing
    in the kernel.  ``min_spikes=1`` skips only all-silent planes and is
    bitwise (the LIF still walks all T); ``min_spikes>1`` drops real spikes
    and requires ``exactness=approximate(tol)``."""

    mode: str = "full"
    min_spikes: int = 1

    def __post_init__(self):
        if self.mode not in TEMPORAL_MODES:
            raise ValueError(
                f"temporal mode {self.mode!r} not in {TEMPORAL_MODES}"
            )
        if self.min_spikes < 1:
            raise ValueError(
                "temporal.min_spikes must be >= 1 (a plane can only be "
                f"skipped for carrying too FEW spikes), got {self.min_spikes}"
            )
        if self.mode == "full" and self.min_spikes != 1:
            raise ValueError(
                "temporal='full' walks every timestep; min_spikes="
                f"{self.min_spikes} is meaningless — use "
                "temporal=adaptive_t(min_spikes=...)"
            )

    @property
    def enabled(self) -> bool:
        return self.mode == "adaptive"

    @property
    def lossy(self) -> bool:
        """True when the scorer may drop planes that carry real spikes."""
        return self.mode == "adaptive" and self.min_spikes > 1

    def describe(self) -> str:
        if self.mode == "full":
            return "full"
        return f"adaptive(min_spikes={self.min_spikes})"


def adaptive_t(min_spikes: int = 1) -> Temporal:
    """Adaptive temporal sparsity: skip timestep planes scoring below
    ``min_spikes``.  The default (1) skips only all-silent planes and stays
    bitwise."""
    return Temporal("adaptive", min_spikes)


@dataclass(frozen=True)
class Paging:
    """How cohort caches are stored: ``"none"`` (dense per-cohort caches,
    merged and gathered by whole-cache concat/take) or ``"paged"`` (KV state
    lives in fixed pages owned by a `serve.paging.CacheStore`; cohorts hold
    page tables, so merge and retire are page-table edits and shared prompt
    prefixes are ref-counted pages instead of re-prefilled rows).

    ``page_size`` is the sequence-positions-per-page granule; it must be a
    positive multiple of 8 (the reference's alignment rule) and must divide
    the cache sequence extent the engine serves (checked at engine
    construction, where the extent is known)."""

    mode: str = "none"
    page_size: int = 8

    def __post_init__(self):
        if self.mode not in PAGING_MODES:
            raise ValueError(f"paging mode {self.mode!r} not in {PAGING_MODES}")
        if self.page_size < 8 or self.page_size % 8:
            raise ValueError(
                "paging.page_size must be a positive multiple of 8, got "
                f"{self.page_size}"
            )

    @property
    def enabled(self) -> bool:
        return self.mode == "paged"

    def describe(self) -> str:
        if self.mode == "none":
            return "none"
        return f"paged(page_size={self.page_size})"


def paged(page_size: int = 8) -> Paging:
    """Paged cache storage (see `serve.paging`)."""
    return Paging("paged", page_size)


@dataclass(frozen=True)
class Speculation:
    """Speculative decoding: a cheap draft `ExecutionPolicy` proposes ``k``
    tokens per slot, the target verifies all ``k + 1`` positions in ONE
    batched decode, and the longest verified-token prefix advances.  The
    draft is the same weights under a cheaper policy (the float path, a
    harder-pruned dual-sparse plan, a lossy temporal gate); every emitted
    token is a target argmax, so the draft decides only how many land per
    round.

    ``draft_weight_density``: prune the draft's FFN weights further than the
    target (its own `WeightJoinPlan`s, built once at load).  Requires a
    dual-sparse draft."""

    mode: str = "none"
    draft: "ExecutionPolicy | None" = None
    k: int = 0
    draft_weight_density: float | None = None

    def __post_init__(self):
        if self.mode not in SPECULATION_MODES:
            raise ValueError(
                f"speculation mode {self.mode!r} not in {SPECULATION_MODES}"
            )
        if self.mode == "none":
            if self.draft is not None or self.k or self.draft_weight_density:
                raise ValueError(
                    "speculation='none' takes no draft policy / k / "
                    "draft_weight_density — use speculation=draft(policy, k)"
                )
            return
        if not isinstance(self.draft, ExecutionPolicy):
            raise ValueError(
                "speculation='draft' needs a full draft ExecutionPolicy, "
                f"got {self.draft!r}"
            )
        if self.k < 1:
            raise ValueError(
                f"speculation needs a proposal length k >= 1, got {self.k}"
            )
        if self.draft.speculation.enabled:
            raise ValueError("draft policies cannot themselves speculate")
        if self.draft.execution != "sync":
            raise ValueError(
                "the draft proposes k chained steps fused in one dispatch; "
                "its execution axis must be 'sync' (got "
                f"{self.draft.execution!r})"
            )
        if self.draft.paging.enabled:
            raise ValueError(
                "draft cache paging is owned by the ENGINE (the draft state "
                "rides the target CacheStore as a second page-table column); "
                "leave the draft policy's paging axis at 'none'"
            )
        if self.draft_weight_density is not None:
            if not 0.0 < self.draft_weight_density <= 1.0:
                raise ValueError(
                    "draft_weight_density must be in (0, 1], got "
                    f"{self.draft_weight_density}"
                )
            if self.draft.weight_sparsity != "dual_sparse":
                raise ValueError(
                    "draft_weight_density prunes the draft's join plan; it "
                    "requires a dual-sparse draft policy (got "
                    f"weight_sparsity={self.draft.weight_sparsity!r})"
                )

    @property
    def enabled(self) -> bool:
        return self.mode == "draft"

    def describe(self) -> str:
        if self.mode == "none":
            return "none"
        d = self.draft
        dd = (f", draft_weight_density={self.draft_weight_density}"
              if self.draft_weight_density is not None else "")
        return (f"draft(k={self.k}, spike_format={d.spike_format!r}, "
                f"weight_sparsity={d.weight_sparsity!r}, "
                f"temporal={d.temporal.describe()}{dd})")


def draft(policy: "ExecutionPolicy", k: int = 4, *,
          draft_weight_density: float | None = None) -> Speculation:
    """Speculative decoding with ``policy`` as the draft proposing ``k``
    tokens per round."""
    return Speculation("draft", policy, k,
                       draft_weight_density=draft_weight_density)


# ---------------------------------------------------------------------------
# the policy
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ExecutionPolicy:
    """Frozen, hashable execution policy; construction validates every
    arch-independent combination, `validate_for(cfg)` the arch-dependent
    ones."""

    spike_format: str = "float"
    weight_sparsity: str = "dense"
    placement: Placement = field(default_factory=Placement)
    exactness: Exactness = field(default_factory=bitwise)
    execution: str = "sync"
    paging: Paging = field(default_factory=Paging)
    temporal: Temporal = field(default_factory=Temporal)
    speculation: Speculation = field(default_factory=Speculation)

    def __post_init__(self):
        if self.execution not in EXECUTION_MODES:
            raise ValueError(
                f"execution {self.execution!r} not in {EXECUTION_MODES}"
            )
        if self.spike_format not in SPIKE_FORMATS:
            raise ValueError(
                f"spike_format {self.spike_format!r} not in {SPIKE_FORMATS}"
            )
        if self.weight_sparsity not in WEIGHT_SPARSITIES:
            raise ValueError(
                f"weight_sparsity {self.weight_sparsity!r} not in "
                f"{WEIGHT_SPARSITIES}"
            )
        if self.weight_sparsity == "dual_sparse" and self.spike_format != "packed":
            raise ValueError(
                "weight_sparsity='dual_sparse' runs the BSR spike-join "
                "kernel, which consumes packed spike words; it requires "
                f"spike_format='packed' (got {self.spike_format!r})"
            )
        if self.temporal.enabled and self.spike_format != "packed":
            raise ValueError(
                "temporal='adaptive' scores the packed timestep bit-planes; "
                f"it requires spike_format='packed' (got {self.spike_format!r})"
            )
        if self.temporal.lossy and self.exactness.mode != "approximate":
            raise ValueError(
                f"temporal=adaptive(min_spikes={self.temporal.min_spikes}) "
                "drops timestep planes that carry real spikes — an "
                "approximation.  Pair it with exactness=approximate(tol) so "
                "the drift is measured and bounded, or use min_spikes=1 "
                "(skip only all-silent planes: provably bitwise)."
            )
        if (self.exactness.mode == "approximate"
                and self.placement.model_size < 2
                and not self.temporal.lossy):
            # lossy temporal skipping is the one single-device source of
            # approximation; without it, approximate needs psum-TP to relax
            raise ValueError(
                "exactness='approximate' relaxes cross-shard reductions "
                "(psum-TP on the model axis); it needs a placement whose "
                "mesh has a model axis >= 2 — got "
                f"{self.placement.describe()}.  For single-device serving "
                "use exactness=bitwise (it is both exact and free here), "
                "unless temporal=adaptive_t(min_spikes>1) supplies the "
                "approximation being bounded."
            )
        if self.speculation.enabled and not self.token_identical:
            # the verified stream is the target's own greedy stream: an
            # approximate target has nothing to verify against (the DRAFT
            # may be as lossy as it likes)
            raise ValueError(
                "speculation requires a bitwise target policy: the verified "
                "stream is defined as the target's own greedy stream, which "
                "exactness='approximate' explicitly relaxes"
            )

        if (self.exactness.mode == "bitwise"
                and self.placement.model_dims is not None):
            from .sharding import MODEL_SHARDED_DIMS

            breaking = set(self.placement.model_dims) - MODEL_SHARDED_DIMS
            if breaking:
                raise ValueError(
                    f"placement.model_dims {sorted(breaking)} put float "
                    "contractions across model shards (psum), which breaks "
                    "the bitwise token-identity contract; use "
                    "exactness=approximate(tol) to opt into bounded drift"
                )
        if self.speculation.enabled and self.speculation.draft.placement.mesh:
            raise ValueError(
                "draft placement is inherited from the target policy (the "
                "draft runs on the same serve mesh); leave the draft "
                "policy's placement unset"
            )

    @property
    def mesh(self):
        return self.placement.mesh

    @property
    def token_identical(self) -> bool:
        """Whether this policy promises bitwise token identity."""
        return self.exactness.mode == "bitwise"

    def model_sharded_dims(self) -> frozenset[str]:
        """Logical weight dims this policy places on the model axis."""
        from .sharding import APPROX_MODEL_SHARDED_DIMS, MODEL_SHARDED_DIMS

        if self.placement.model_dims is not None:
            return frozenset(self.placement.model_dims)
        if self.exactness.mode == "approximate":
            return APPROX_MODEL_SHARDED_DIMS
        return MODEL_SHARDED_DIMS

    def describe(self) -> str:
        ex = self.exactness.mode
        if ex == "approximate":
            ex += f"(tol={self.exactness.tol})"
        return (f"spike_format={self.spike_format!r}, "
                f"weight_sparsity={self.weight_sparsity!r}, "
                f"placement={self.placement.describe()}, exactness={ex}, "
                f"execution={self.execution!r}, "
                f"paging={self.paging.describe()}, "
                f"temporal={self.temporal.describe()}, "
                f"speculation={self.speculation.describe()}")

    def validate_for(self, cfg) -> "ExecutionPolicy":
        """Arch-dependent checks (an `ArchConfig`); returns self."""
        if self.spike_format == "packed" and not cfg.spiking_ffn:
            raise ValueError(
                f"spike_format='packed' needs a spiking-FFN arch; {cfg.name} "
                "has spiking_ffn=False (set cfg.spiking_ffn or use "
                "spike_format='float')"
            )
        if self.weight_sparsity == "dual_sparse":
            if cfg.spiking_weight_density >= 1.0:
                raise ValueError(
                    "weight_sparsity='dual_sparse' joins against LTH hard "
                    f"zeros, but {cfg.name} has spiking_weight_density="
                    f"{cfg.spiking_weight_density} (unpruned); prune at init "
                    "(spiking_weight_density < 1) or use weight_sparsity='dense'"
                )
        if self.speculation.enabled:
            spec = self.speculation
            # same arch and T by construction: one engine, one param tree
            spec.draft.validate_for(cfg)
            if getattr(cfg, "n_experts", 0):
                raise ValueError(
                    "speculation needs row-independent decode (acceptance "
                    f"rolls individual rows back), but {cfg.name} routes "
                    f"across {cfg.n_experts} experts — capacity routing "
                    "couples batch rows"
                )
            if getattr(cfg, "attn", "causal") != "causal":
                raise ValueError(
                    "speculative rollback rewinds the cache position and "
                    "relies on absolute-position masking to hide stale "
                    f"slots; {cfg.name} uses attn={cfg.attn!r} (a windowed/"
                    "ring cache wraps, so rejected writes may have evicted "
                    "live history)"
                )
            if (spec.draft_weight_density is not None
                    and spec.draft_weight_density > cfg.spiking_weight_density):
                raise ValueError(
                    "draft_weight_density must prune AT LEAST as hard as "
                    f"the target ({spec.draft_weight_density} > "
                    f"cfg.spiking_weight_density={cfg.spiking_weight_density})"
                )
        return self

    @classmethod
    def for_arch(cls, cfg, *, spike_format: str | None = None,
                 weight_sparsity: str | None = None,
                 placement: Placement | None = None,
                 exactness: Exactness | None = None,
                 execution: str | None = None,
                 paging: Paging | None = None,
                 temporal: Temporal | None = None,
                 speculation: Speculation | None = None) -> "ExecutionPolicy":
        """Arch-aware constructor, ``None`` = the natural default: packed
        spikes for spiking archs, dual-sparse when the weights are pruned,
        bitwise, sync execution, dense (non-paged) cache storage, full
        temporal walk, no speculation."""
        if spike_format is None:
            spike_format = "packed" if cfg.spiking_ffn else "float"
        if weight_sparsity is None:
            weight_sparsity = (
                "dual_sparse"
                if spike_format == "packed" and cfg.spiking_weight_density < 1.0
                else "dense"
            )
        return cls(
            spike_format=spike_format,
            weight_sparsity=weight_sparsity,
            placement=placement if placement is not None else Placement(),
            exactness=exactness if exactness is not None else bitwise(),
            execution=execution if execution is not None else "sync",
            paging=paging if paging is not None else Paging(),
            temporal=temporal if temporal is not None else Temporal(),
            speculation=(speculation if speculation is not None
                         else Speculation()),
        ).validate_for(cfg)


# Common arch-independent policies (kernel-level callers: dispatch, tests,
# spiking layers).  Engine-level code should go through `for_arch`.
FLOAT_DENSE = ExecutionPolicy()
PACKED_DENSE = ExecutionPolicy(spike_format="packed")
PACKED_DUAL = ExecutionPolicy(spike_format="packed", weight_sparsity="dual_sparse")
# Triple-sparse: weights x spikes x timesteps, bitwise (min_spikes=1).
PACKED_DUAL_ADAPTIVE = ExecutionPolicy(spike_format="packed",
                                       weight_sparsity="dual_sparse",
                                       temporal=adaptive_t())


# ---------------------------------------------------------------------------
# speculative acceptance (longest verified-token prefix)
# ---------------------------------------------------------------------------

def acceptance_lengths(draft_tokens, target_tokens) -> np.ndarray:
    """Per-row longest accepted prefix of a speculative round.

    ``draft_tokens``: (B, k) proposals; ``target_tokens``: (B, >= k) greedy
    argmax of the target's verify logits (column j is the target's choice
    given the stream up through draft position j - 1).  Row i accepts
    ``max a such that draft[i, :a] == target[i, :a]``, so ``0 <= a <= k``;
    an all-reject round still lands the bonus token ``target[i, 0]``, and
    ``k = 0`` is plain decoding."""
    d = np.asarray(draft_tokens)
    if d.ndim != 2:
        raise ValueError(f"draft_tokens must be (B, k), got shape {d.shape}")
    t = np.asarray(target_tokens)[:, : d.shape[1]]
    if t.shape != d.shape:
        raise ValueError(
            f"target must cover every proposed position: draft {d.shape} "
            f"vs target {np.asarray(target_tokens).shape}"
        )
    if d.shape[1] == 0:
        return np.zeros(d.shape[0], dtype=np.int64)
    mismatch = d != t
    first = np.where(mismatch.any(axis=1), mismatch.argmax(axis=1), d.shape[1])
    return first.astype(np.int64)


# ---------------------------------------------------------------------------
# parity checking
# ---------------------------------------------------------------------------

class ParityError(AssertionError):
    """A serving run broke its policy's exactness contract."""


def max_logit_drift(ref_tokens, got_tokens, ref_logits, got_logits) -> float:
    """Max |logit difference| over the common-prefix steps of one request.

    Drift is only defined while both runs saw identical inputs: once a
    greedy token flips, later steps compute different functions.  The step
    of the first mismatch is included (its logits came from identical
    inputs; the flip is its consequence)."""
    drift = 0.0
    for i in range(min(len(ref_logits), len(got_logits))):
        a = np.asarray(ref_logits[i], np.float32)
        b = np.asarray(got_logits[i], np.float32)
        drift = max(drift, float(np.max(np.abs(a - b))))
        if i < min(len(ref_tokens), len(got_tokens)) and \
                int(ref_tokens[i]) != int(got_tokens[i]):
            break  # inputs diverge from the next step on
    return drift


def drift_report(ref_tokens_by_req, got_tokens_by_req,
                 ref_logits_by_req, got_logits_by_req) -> dict:
    """Aggregate drift/match stats across requests (parallel lists)."""
    drift, n_tok, n_match = 0.0, 0, 0
    for rt, gt, rl, gl in zip(ref_tokens_by_req, got_tokens_by_req,
                              ref_logits_by_req, got_logits_by_req):
        drift = max(drift, max_logit_drift(rt, gt, rl, gl))
        # max-length denominator: a run that stopped early counts its
        # missing tokens as mismatches
        n_tok += max(len(rt), len(gt))
        n_match += sum(int(a) == int(b) for a, b in zip(rt, gt))
    return {
        "max_logit_drift": drift,
        "token_match_fraction": n_match / max(1, n_tok),
        "tokens_compared": n_tok,
    }


def check_parity(policy: ExecutionPolicy, ref_tokens, got_tokens, *,
                 ref_logits=None, got_logits=None) -> dict:
    """Assert the policy's exactness contract between a reference run and a
    policy run; returns the measured report.

    Bitwise policies assert token identity.  Approximate policies assert
    max logit drift <= ``tol`` (needs the per-request logit traces of both
    runs, e.g. `Engine.drain_logit_traces`) and report the drift and the
    token-match fraction."""
    if len(ref_tokens) != len(got_tokens):
        raise ParityError(
            f"request count mismatch: reference produced {len(ref_tokens)} "
            f"outputs, policy run produced {len(got_tokens)} — a run "
            "dropped requests; zip-truncating would hide that"
        )
    if policy.token_identical:
        for i, (a, b) in enumerate(zip(ref_tokens, got_tokens)):
            if not np.array_equal(np.asarray(a), np.asarray(b)):
                raise ParityError(
                    f"bitwise policy broke token identity on request {i}: "
                    f"{np.asarray(a)!r} != {np.asarray(b)!r}"
                )
        return {"token_identical": True}
    if ref_logits is None or got_logits is None:
        raise ValueError(
            "approximate parity needs logit traces from both runs "
            "(Engine(capture_logits=True) keeps them in engine.logit_traces)"
        )
    rep = drift_report(ref_tokens, got_tokens, ref_logits, got_logits)
    rep["token_identical"] = rep["token_match_fraction"] == 1.0
    rep["tol"] = policy.exactness.tol
    if rep["max_logit_drift"] > policy.exactness.tol:
        raise ParityError(
            f"approximate policy exceeded its drift bound: measured "
            f"{rep['max_logit_drift']:.3e} > tol {policy.exactness.tol:.3e}"
        )
    return rep
