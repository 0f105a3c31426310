"""Event-stream serving example on the PyTorch/CUDA port (port of
`serve_dvs.py`): a DVS-style sensor feeding the engine.

A synthetic moving-blob event stream (`repro_torch.data.events`) is pushed
into an `EventStream` one window per engine step; each complete window
encodes to a packed spike frame and a frame token, and the engine ingests
it into the in-flight cohort.  Generation starts at the stream's close
watermark.  The script then replays the frame tokens as an ordinary prompt
on a fresh engine and checks that the incremental path gives the same
tokens, bit for bit.

    PYTHONPATH=src python examples/serve_dvs_torch.py               # the card
    PYTHONPATH=src python examples/serve_dvs_torch.py --device cpu  # plain torch

Without ``--device`` and without a card it raises instead of running on
the CPU.
"""
import argparse
import dataclasses

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs import get_config, smoke_variant
from repro_torch.data.events import moving_blob_events, split_into_windows
from repro_torch.models.registry import build_model
from repro_torch.serve import (
    Engine,
    EventStream,
    ExecutionPolicy,
    StreamSession,
    adaptive_t,
)

N_WIN, WINDOW_US, GEN = 8, 1000, 8
SILENT = ((), (3,))  # per stream: the windows with no events


def example_config():
    """llama3.2-1b's smoke variant with spiking FFNs at weight density 0.3."""
    cfg = smoke_variant(get_config("llama3_2_1b"))
    return dataclasses.replace(cfg, spiking_ffn=True, spiking_weight_density=0.3)


def run(device=None, params=None, log=print) -> dict:
    """Serve the two streams from ``params`` (the seed-0 params when None)
    and replay their frame tokens as prompts; returns both runs' tokens,
    the frame tokens and the engine's summary."""
    dev = resolve_device(device)
    cfg = example_config()
    model = build_model(cfg)
    if params is None:
        params = model.init(0, device=dev)
    policy = ExecutionPolicy.for_arch(cfg, temporal=adaptive_t(1))
    engine = Engine(model, params, max_len=N_WIN + GEN, max_slots=2,
                    policy=policy, device=dev)

    # two streams: one continuous gesture, one with a silent window mid-stream
    # (the gap frame's all-silent timestep planes are skipped in the kernel
    # under the adaptive temporal policy)
    sessions, tickets, feeds = [], [], []
    for i, silent in enumerate(SILENT):
        events = moving_blob_events(N_WIN, height=16, width=16,
                                    window_us=WINDOW_US, seed=i, silent=silent)
        session = StreamSession(EventStream(WINDOW_US), height=16, width=16,
                                T=cfg.spiking_T, vocab=cfg.vocab)
        tickets.append(engine.submit_stream(session, GEN))
        sessions.append(session)
        feeds.append(split_into_windows(events, N_WIN, WINDOW_US))

    for w in range(N_WIN):                      # sensor: one window per step
        for session, chunks in zip(sessions, feeds):
            session.stream.push(chunks[w])
        engine.step()
    for session in sessions:
        session.stream.close()                  # end-of-stream watermark
    out = engine.run()
    s = engine.summary()

    # the same frame tokens as a one-shot prompt
    ref = Engine(model, params, max_len=N_WIN + GEN, max_slots=2,
                 policy=policy, device=dev)
    ref_tickets = [ref.submit(sess.prompt_tokens(), GEN) for sess in sessions]
    ref_out = ref.run()
    tokens = [out[t.rid] for t in tickets]
    one_shot = [ref_out[r.rid] for r in ref_tickets]
    identical = all(np.array_equal(a, b) for a, b in zip(tokens, one_shot))
    log(f"streamed {s['stream_sessions']} sessions / {s['stream_windows']} "
        f"frames, frame->first-token p50 "
        f"{s['frame_to_first_token_s_p50'] * 1e3:.0f}ms / p99 "
        f"{s['frame_to_first_token_s_p99'] * 1e3:.0f}ms | "
        f"{s['timesteps_skipped']} silent timestep planes skipped | "
        f"incremental == one-shot: {identical}")
    assert identical, "stream ingestion diverged from the one-shot prompt"
    return {"frame_tokens": [sess.prompt_tokens() for sess in sessions],
            "tokens": tokens, "one_shot": one_shot, "summary": s}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    return run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
