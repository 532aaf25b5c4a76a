"""Continuous batching: outputs must match standalone greedy generation even
with staggered admission and mixed-length requests sharing the batch."""

import numpy as np
import pytest

from kquant.models.fixtures import tiny_config, write_fixture_gguf
from kquant.runtime import InferenceEngine, load_model
from kquant.serving import ContinuousBatcher, Request


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    path = tmp_path_factory.mktemp("m") / "serve.gguf"
    cfg = tiny_config(n_layers=2, dim=64, n_heads=4, n_kv_heads=2, ffn_dim=128,
                      vocab_size=512, max_seq_len=256)
    write_fixture_gguf(path, cfg, seed=13, quant="q4_k_m", scale=0.08)
    cfg, params, _ = load_model(str(path))
    return cfg, params


def test_single_request_matches_generate(setup):
    cfg, params = setup
    eng = InferenceEngine(cfg, params, max_batch=2, max_seq=64, impl="xla")
    want = eng.generate([[3, 100, 7]], max_new_tokens=6)[0]

    cb = ContinuousBatcher(eng)
    cb.submit(Request(prompt=[3, 100, 7], max_new_tokens=6))
    done = cb.run()
    assert len(done) == 1
    assert done[0].output == want


def test_concurrent_requests_match(setup):
    cfg, params = setup
    eng = InferenceEngine(cfg, params, max_batch=4, max_seq=64, impl="xla")
    prompts = [[3, 100, 7], [9, 300], [17, 5, 11, 200, 42], [250]]
    want = [eng.generate([p], max_new_tokens=5)[0] for p in prompts]

    cb = ContinuousBatcher(eng)
    for p in prompts:
        cb.submit(Request(prompt=p, max_new_tokens=5))
    done = sorted(cb.run(), key=lambda r: r.rid)
    assert [r.output for r in done] == want


def test_more_requests_than_slots(setup):
    """Requests queue and join as slots free up (true continuous batching)."""
    cfg, params = setup
    eng = InferenceEngine(cfg, params, max_batch=2, max_seq=64, impl="xla")
    prompts = [[3, 100, 7], [9, 300], [17, 5, 11], [250, 9], [77]]
    want = [eng.generate([p], max_new_tokens=4)[0] for p in prompts]

    cb = ContinuousBatcher(eng)
    for i, p in enumerate(prompts):
        cb.submit(Request(prompt=p, max_new_tokens=4))
    done = sorted(cb.run(), key=lambda r: r.rid)
    assert len(done) == 5
    assert [r.output for r in done] == want


def test_staggered_admission(setup):
    """A request submitted mid-flight must not disturb running sequences."""
    cfg, params = setup
    eng = InferenceEngine(cfg, params, max_batch=2, max_seq=64, impl="xla")
    w0 = eng.generate([[3, 100, 7]], max_new_tokens=8)[0]
    w1 = eng.generate([[9, 300]], max_new_tokens=4)[0]

    cb = ContinuousBatcher(eng)
    cb.submit(Request(prompt=[3, 100, 7], max_new_tokens=8))
    for _ in range(3):
        cb.step()
    cb.submit(Request(prompt=[9, 300], max_new_tokens=4))
    done = sorted(cb.run(), key=lambda r: r.rid)
    assert done[0].output == w0
    assert done[1].output == w1


def test_penalties_match_generate(setup):
    """Greedy + penalties is deterministic: a served request must reproduce
    engine.generate exactly (the per-request penalty window lives on-device)."""
    cfg, params = setup
    eng = InferenceEngine(cfg, params, max_batch=2, max_seq=64, impl="xla")
    want = eng.generate([[3, 100, 7]], max_new_tokens=10, repeat_penalty=1e9,
                        penalty_last_n=64)[0]
    cb = ContinuousBatcher(eng)
    cb.submit(Request(prompt=[3, 100, 7], max_new_tokens=10,
                      repeat_penalty=1e9, penalty_last_n=64))
    done = cb.run()
    assert done[0].output == want


def test_sampled_output_independent_of_batch_composition(setup):
    """Per-request seeds: the same sampled request must produce the same
    tokens whether it runs alone or shares the batch with other requests."""
    cfg, params = setup
    eng = InferenceEngine(cfg, params, max_batch=4, max_seq=64, impl="xla")

    def serve(reqs):
        cb = ContinuousBatcher(eng)
        for r in reqs:
            cb.submit(r)
        return {r.rid: r.output for r in cb.run()}

    mk = lambda: Request(prompt=[3, 100, 7], max_new_tokens=8, temperature=0.8,
                         top_k=50, min_p=0.05, seed=1234)
    alone = serve([mk()])
    crowd_reqs = [Request(prompt=[9, 300], max_new_tokens=8, temperature=1.2,
                          seed=1), mk(),
                  Request(prompt=[250], max_new_tokens=3, temperature=0.5,
                          seed=2)]
    crowd = serve(crowd_reqs)
    assert alone[0] == crowd[crowd_reqs[1].rid]


def test_heterogeneous_sampler_params_one_batch(setup):
    """Greedy and sampled rows share one batched sampler dispatch; the greedy
    row must still match standalone greedy generation."""
    cfg, params = setup
    eng = InferenceEngine(cfg, params, max_batch=3, max_seq=64, impl="xla")
    want = eng.generate([[3, 100, 7]], max_new_tokens=6)[0]
    cb = ContinuousBatcher(eng)
    cb.submit(Request(prompt=[3, 100, 7], max_new_tokens=6))  # greedy
    cb.submit(Request(prompt=[9, 300], max_new_tokens=6, temperature=1.0,
                      top_p=0.9, min_p=0.1, seed=5))
    cb.submit(Request(prompt=[17, 5], max_new_tokens=6, temperature=0.7,
                      frequency_penalty=0.5, penalty_last_n=32, seed=6))
    done = sorted(cb.run(), key=lambda r: r.rid)
    assert done[0].output == want
    assert all(len(r.output) == 6 for r in done)


def test_eos_stops_early(setup):
    cfg, params = setup
    eng = InferenceEngine(cfg, params, max_batch=2, max_seq=64, impl="xla")
    probe = eng.generate([[3, 100, 7]], max_new_tokens=8)[0]
    eos = probe[2]  # force early stop at the 3rd generated token
    cb = ContinuousBatcher(eng)
    cb.submit(Request(prompt=[3, 100, 7], max_new_tokens=8, eos_id=eos))
    done = cb.run()
    assert done[0].output == probe[:3]


def test_chunked_run_matches_per_tick(setup):
    """Multi-tick fused chunks (run max_chunk>1) must emit bit-identical
    token streams to pure per-tick stepping — the chunk is the same tick
    body chained in a lax.scan, with admissions only at chunk boundaries."""
    cfg, params = setup

    def drive(max_chunk):
        eng = InferenceEngine(cfg, params, max_batch=2, max_seq=64,
                              impl="xla")
        cb = ContinuousBatcher(eng, seed=5)
        reqs = [
            Request(prompt=[3, 100, 7], max_new_tokens=9),
            Request(prompt=[9, 300], max_new_tokens=4,
                    temperature=0.9, top_k=20, seed=11),
            Request(prompt=[17, 5, 11], max_new_tokens=7,
                    temperature=0.7, repeat_penalty=1.2, seed=3),
            Request(prompt=[250, 9], max_new_tokens=6),
        ]
        for r in reqs:
            cb.submit(r)
        done = sorted(cb.run(max_chunk=max_chunk), key=lambda r: r.rid)
        return [r.output for r in done]

    assert drive(8) == drive(1)


def test_chunked_run_eos_truncates(setup):
    """A chunk may decode past a request's eos; emitted output must still
    stop at eos exactly as per-tick stepping does."""
    cfg, params = setup

    def drive(max_chunk):
        eng = InferenceEngine(cfg, params, max_batch=2, max_seq=64,
                              impl="xla")
        cb = ContinuousBatcher(eng)
        cb.submit(Request(prompt=[3, 100, 7], max_new_tokens=24, eos_id=None))
        base = cb.run(max_chunk=max_chunk)[0].output
        eos = base[5]  # force an eos mid-stream
        eng2 = InferenceEngine(cfg, params, max_batch=2, max_seq=64,
                               impl="xla")
        cb2 = ContinuousBatcher(eng2)
        cb2.submit(Request(prompt=[3, 100, 7], max_new_tokens=24, eos_id=eos))
        return cb2.run(max_chunk=max_chunk)[0].output

    assert drive(8) == drive(1)


def test_chunk_eos_early_exit(setup):
    """The device chunk loop freezes a row at its eos and exits once every
    row has hit one — an eos-heavy workload must not burn the full chunk's
    ticks (r4 capped chunks at 4 on the host instead)."""
    cfg, params = setup
    eng = InferenceEngine(cfg, params, max_batch=2, max_seq=64, impl="xla")
    base = eng.generate([[3, 100, 7]], max_new_tokens=24)[0]
    eos = base[5]

    cut = base.index(eos)  # the stream stops at eos's FIRST occurrence

    eng2 = InferenceEngine(cfg, params, max_batch=2, max_seq=64, impl="xla")
    cb = ContinuousBatcher(eng2)
    cb.submit(Request(prompt=[3, 100, 7], max_new_tokens=24, eos_id=eos))
    out = cb.run(max_chunk=32)[0].output
    assert out == base[: cut + 1]
    # 1 admission tick + a chunk that exits at the eos tick — not 24
    assert cb.stats["steps"] <= cut + 3


def test_submit_rejects_oversized_prompt(setup):
    """Validation happens at submit(), before any slot state exists — a
    caller that catches the error keeps a healthy batcher (ADVICE r4)."""
    cfg, params = setup
    eng = InferenceEngine(cfg, params, max_batch=2, max_seq=32, impl="xla")
    cb = ContinuousBatcher(eng)
    with pytest.raises(ValueError):
        cb.submit(Request(prompt=list(range(40)), max_new_tokens=4))
    cb.submit(Request(prompt=[3, 100, 7], max_new_tokens=4))
    done = cb.run()
    assert len(done) == 1 and len(done[0].output) == 4


def test_serving_sharded_tp_int8kv_parity(tmp_path):
    """BASELINE config #3 evidence: the ContinuousBatcher ticking over a
    DP+TP mesh with an int8-quantized KV cache — sharded-weight/-cache/
    -state serving must reproduce the unsharded engine's greedy streams
    bit-for-bit, through staggered admissions and retirements."""
    from kquant.parallel import make_mesh, make_param_put

    mesh = make_mesh(data=2, model=4)
    cfg = tiny_config(n_layers=2, dim=32 * 4, n_heads=2 * 4, n_kv_heads=4,
                      ffn_dim=256, vocab_size=512, max_seq_len=128)
    path = tmp_path / "serve_tp.gguf"
    write_fixture_gguf(path, cfg, seed=21, quant="q4_k_m", scale=0.08)

    prompts = [[3, 100, 7], [9, 300], [17, 5, 11, 200, 42], [250],
               [12, 13], [77, 99, 101]]

    def drive(put, mesh_arg):
        cfg2, params, _ = load_model(str(path), put=put)
        eng = InferenceEngine(cfg2, params, max_batch=4, max_seq=64,
                              impl="xla", kv_quantized=True)
        cb = ContinuousBatcher(eng, mesh=mesh_arg)
        for p in prompts:
            cb.submit(Request(prompt=p, max_new_tokens=5))
        done = sorted(cb.run(), key=lambda r: r.rid)
        return [r.output for r in done]

    want = drive(None, None)
    got = drive(make_param_put(mesh), mesh)
    assert got == want
