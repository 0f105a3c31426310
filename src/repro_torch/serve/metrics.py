"""Per-request and engine-level serving metrics (port of
`repro.serve.metrics`, the counters of the single-device serve features:
pipelining, paging, speculation and event streams).

Times are host wall clock (`time.perf_counter`).  The sync executor waits
for each step's sampled tokens on the host, so on a GPU its stage times
cover the device work they launched; under the pipelined executor the
decode stage is dispatch only, and the wait moves to ``sample_sync``.
"""
from __future__ import annotations

from dataclasses import MISSING, dataclass, field, fields


def _percentile(sorted_vals: list[float], q: float) -> float:
    if not sorted_vals:
        return float("nan")
    idx = min(len(sorted_vals) - 1, max(0, round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


@dataclass(frozen=True)
class RequestMetrics:
    rid: int
    prompt_len: int
    n_generated: int
    ttft_s: float       # submit -> first token emitted
    latency_s: float    # submit -> finished
    finish_reason: str


@dataclass
class EngineMetrics:
    """Aggregated over one engine lifetime (or between `reset()` calls)."""

    completed: list[RequestMetrics] = field(default_factory=list)
    n_prefill_batches: int = 0
    n_decode_batches: int = 0
    n_decode_rows: int = 0        # sum of cohort batch sizes over decode calls
    n_merges: int = 0
    n_padded_rows: int = 0        # dummy rows added for batch alignment
    n_rebalances: int = 0         # mesh cohorts re-packed on load skew
    # paging='paged' counters.  n_page_moves counts page-granular COPIES
    # (prefix publish snapshots + copy-on-write at the divergence page);
    # cohort merge and retire are page-table edits and must add 0.
    n_page_moves: int = 0
    n_prefix_hits: int = 0        # requests admitted from the radix index
    n_prefix_tokens_reused: int = 0   # prompt tokens whose prefill was skipped
    n_straggler_events: int = 0   # StepTimer detections fed from stage_s
    n_remeshes: int = 0           # live serve-mesh re-plans (Engine.remesh)
    n_drained: int = 0            # requests handed off unfinished at drain
    # event streams (serve/streaming.py): sessions admitted through the
    # scheduler's stream lane, frames ingested, and each frame's wait from
    # its window's completion to the session's first generated token
    n_stream_sessions: int = 0
    n_stream_windows: int = 0
    stream_frame_latency_s: list = field(default_factory=list)
    # speculation=draft(...): per live row a round proposes k tokens, the
    # longest matching prefix is accepted and the rest rejected (proposed
    # == accepted + rejected); the bonus target token is neither
    n_speculative_rounds: int = 0
    n_draft_batches: int = 0      # fused k-step propose dispatches
    n_draft_prefills: int = 0     # draft-cache (re)builds
    n_tokens_proposed: int = 0
    n_tokens_accepted: int = 0
    n_tokens_rejected: int = 0
    max_queue_depth: int = 0
    wall_s: float = 0.0
    # per-stage wall time: admit / prefill / merge / decode / sample_sync /
    # encode / retire (+ admit_hits with a prefix index).  Sync: the
    # per-step host wait lands in sample_sync.  Pipelined: decode is
    # dispatch only and sample_sync is the deferred drain, which overlaps
    # the decode steps still on the device.
    stage_s: dict[str, float] = field(default_factory=dict)
    # temporal='adaptive': timestep planes of encoded spike batches scoring
    # below the policy's min_spikes, counted at the encode boundary.  It
    # accumulates on the device (an int, or a 0-d tensor once counted) and
    # is read on the host only in `summary()`.
    timesteps_skipped: object = 0

    def record(self, m: RequestMetrics) -> None:
        self.completed.append(m)

    def reset(self) -> None:
        """Zero every aggregate in place (references stay live)."""
        for f in fields(self):
            setattr(self, f.name,
                    f.default_factory() if f.default_factory is not MISSING
                    else f.default)

    def sample_queue_depth(self, depth: int) -> None:
        self.max_queue_depth = max(self.max_queue_depth, int(depth))

    @property
    def total_tokens(self) -> int:
        return sum(m.n_generated for m in self.completed)

    @property
    def throughput_tok_s(self) -> float:
        return self.total_tokens / self.wall_s if self.wall_s > 0 else float("nan")

    @property
    def mean_decode_batch(self) -> float:
        if not self.n_decode_batches:
            return 0.0
        return self.n_decode_rows / self.n_decode_batches

    def summary(self) -> dict:
        ttfts = sorted(m.ttft_s for m in self.completed)
        lats = sorted(m.latency_s for m in self.completed)
        return {
            "n_requests": len(self.completed),
            "total_tokens": self.total_tokens,
            "wall_s": self.wall_s,
            "throughput_tok_s": self.throughput_tok_s,
            "ttft_s_p50": _percentile(ttfts, 0.50),
            "ttft_s_p99": _percentile(ttfts, 0.99),
            "latency_s_p50": _percentile(lats, 0.50),
            "latency_s_p99": _percentile(lats, 0.99),
            "prefill_batches": self.n_prefill_batches,
            "decode_batches": self.n_decode_batches,
            "mean_decode_batch": self.mean_decode_batch,
            "cohort_merges": self.n_merges,
            "padded_rows": self.n_padded_rows,
            "rebalances": self.n_rebalances,
            "page_moves": self.n_page_moves,
            "prefix_hits": self.n_prefix_hits,
            "prefix_tokens_reused": self.n_prefix_tokens_reused,
            "drained_requests": self.n_drained,
            "straggler_events": self.n_straggler_events,
            "remeshes": self.n_remeshes,
            "speculative_rounds": self.n_speculative_rounds,
            "draft_batches": self.n_draft_batches,
            "draft_prefills": self.n_draft_prefills,
            "tokens_proposed": self.n_tokens_proposed,
            "tokens_accepted": self.n_tokens_accepted,
            "tokens_rejected": self.n_tokens_rejected,
            "acceptance_rate": (
                self.n_tokens_accepted / max(1, self.n_tokens_proposed)
            ),
            "stream_sessions": self.n_stream_sessions,
            "stream_windows": self.n_stream_windows,
            "frame_to_first_token_s_p50": _percentile(
                sorted(self.stream_frame_latency_s), 0.50
            ),
            "frame_to_first_token_s_p99": _percentile(
                sorted(self.stream_frame_latency_s), 0.99
            ),
            "max_queue_depth": self.max_queue_depth,
            "stage_s": {k: self.stage_s[k] for k in sorted(self.stage_s)},
            "timesteps_skipped": int(self.timesteps_skipped),
        }
