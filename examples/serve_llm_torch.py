"""Serving example on the PyTorch/CUDA port (port of `serve_llm.py`): the
continuous-batching engine over three cache types (transformer KV cache,
RWKV recurrent state, Zamba2 hybrid state), with staggered arrivals so a
late prefill merges into the in-flight decode cohort.

    PYTHONPATH=src python examples/serve_llm_torch.py               # the card
    PYTHONPATH=src python examples/serve_llm_torch.py --device cpu  # plain torch

Without ``--device`` and without a card it raises instead of running on
the CPU.
"""
import argparse

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs import get_config, smoke_variant
from repro_torch.models.registry import build_model
from repro_torch.serve import Engine, ExecutionPolicy

ARCHS = ("llama3_2_1b", "rwkv6_1_6b", "zamba2_7b")
P, G = 32, 12  # prompt tokens, new tokens


def serve(arch: str, device=None, params=None, log=print) -> dict:
    """Serve the example's four requests on ``arch``'s smoke variant, from
    ``params`` (the seed-0 params when None); returns the prompts, each
    request's tokens and the engine's summary."""
    dev = resolve_device(device)
    cfg = smoke_variant(get_config(arch))
    model = build_model(cfg)
    if params is None:
        params = model.init(0, device=dev)
    rng = np.random.default_rng(0)
    # one declarative execution policy (here: the arch-derived default —
    # float spikes, dense weights, single device, bitwise token identity)
    policy = ExecutionPolicy.for_arch(cfg)
    engine = Engine(model, params, max_len=P + 1 + G, max_slots=4,
                    batch_align=2, policy=policy, device=dev)

    # first wave of 3 requests; after one engine step (prefill + 1 decode,
    # sequence position P+1) a late arrival with a (P+1)-token prompt lands
    # exactly on the in-flight cohort's position and merges into it
    prompts = [rng.integers(0, cfg.vocab, size=(P,)) for _ in range(3)]
    reqs = [engine.submit(p, G) for p in prompts]
    engine.step()
    prompts.append(rng.integers(0, cfg.vocab, size=(P + 1,)))
    reqs.append(engine.submit(prompts[-1], G))
    out = engine.run()
    s = engine.summary()
    tokens = [out[r.rid] for r in reqs]
    log(f"{arch:14s} {s['n_requests']} reqs {s['total_tokens']} toks "
        f"in {s['wall_s']:5.1f}s | merges={s['cohort_merges']} "
        f"mean_decode_batch={s['mean_decode_batch']:.1f} "
        f"| first tokens {tokens[0][:6]}")
    return {"arch": arch, "prompts": prompts, "tokens": tokens, "summary": s}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    return [serve(arch, args.device) for arch in ARCHS]


if __name__ == "__main__":
    main()
