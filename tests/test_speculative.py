"""Speculative decoding invariant: greedy draft-verify emits EXACTLY the
target model's greedy sequence, for any draft model — draft quality only
changes the acceptance rate (speed), never the output.
"""

import numpy as np
import pytest

from kquant.models.fixtures import tiny_config, write_fixture_gguf
from kquant.runtime import InferenceEngine, load_model
from kquant.runtime.speculative import generate_speculative


def _engine(tmp, name, seed, **kw):
    path = tmp / f"{name}.gguf"
    cfg = tiny_config(n_layers=2, dim=64, n_heads=4, n_kv_heads=2, ffn_dim=128,
                      vocab_size=512, **kw)
    write_fixture_gguf(path, cfg, seed=seed, scale=0.08)
    cfg, params, _ = load_model(str(path))
    return InferenceEngine(cfg, params, max_batch=2, max_seq=128, impl="xla")


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spec")
    target = _engine(tmp, "target", seed=7)
    bad_draft = _engine(tmp, "draft", seed=99)  # different weights
    return target, bad_draft


def test_perfect_draft_accepts_everything(engines):
    target, _ = engines
    prompts = [[3, 5, 7, 11]]
    want = target.generate(prompts, max_new_tokens=12)
    got, stats = generate_speculative(target, target, prompts,
                                      max_new_tokens=12, n_draft=4)
    assert got[0] == want[0]
    assert stats["accepted"] == stats["drafted"]  # self-draft: all accepted
    # 1 round emits n_draft+1 tokens; 12 tokens need ceil(11/5)+prefill
    assert stats["rounds"] <= 3


def test_bad_draft_output_unchanged(engines):
    target, bad_draft = engines
    prompts = [[3, 5, 7, 11, 2, 9]]
    want = target.generate(prompts, max_new_tokens=16)
    got, stats = generate_speculative(target, bad_draft, prompts,
                                      max_new_tokens=16, n_draft=4)
    assert got[0] == want[0]
    assert stats["accepted"] < stats["drafted"]  # random draft: mostly rejected


def test_batched_rows_diverge(engines):
    target, bad_draft = engines
    prompts = [[3, 5, 7], [100, 20, 9, 42, 8]]
    want = target.generate(prompts, max_new_tokens=10)
    got, _ = generate_speculative(target, bad_draft, prompts,
                                  max_new_tokens=10, n_draft=3)
    assert got[0] == want[0]
    assert got[1] == want[1]


def test_eos_stops_row(engines):
    target, _ = engines
    prompts = [[3, 5, 7, 11]]
    want = target.generate(prompts, max_new_tokens=12, eos_id=None)
    eos = want[0][4]  # pretend the 5th generated token is EOS
    want_eos = target.generate(prompts, max_new_tokens=12, eos_id=eos)
    got, _ = generate_speculative(target, target, prompts, max_new_tokens=12,
                                  n_draft=4, eos_id=eos)
    assert got[0] == want_eos[0]


def test_device_speculator_ngram_matches_greedy(engines):
    """The fully device-resident loop (one dispatch per generation) with
    the prompt-lookup n-gram draft emits exactly the plain greedy stream —
    rejected lookups are replaced by the target's own argmax."""
    from kquant.runtime.speculative import DeviceSpeculator

    target, _ = engines
    prompts = [[3, 5, 7, 11], [9, 300]]
    want = target.generate(prompts, max_new_tokens=16)
    sp = DeviceSpeculator(target, None, n_draft=4, ngram=2)
    got, stats = sp.generate(prompts, max_new_tokens=16)
    assert got == want
    assert stats["rounds"] >= 1


def test_device_speculator_two_model_matches_greedy(engines):
    """Device-resident two-model speculation: a WRONG draft model must
    still emit the target's exact greedy stream (only speed may differ)."""
    from kquant.runtime.speculative import DeviceSpeculator

    target, bad_draft = engines
    prompts = [[3, 5, 7, 11]]
    want = target.generate(prompts, max_new_tokens=14)
    sp = DeviceSpeculator(target, bad_draft, n_draft=4)
    got, stats = sp.generate(prompts, max_new_tokens=14)
    assert got == want


def test_device_speculator_repetitive_text_accepts(engines):
    """On a repeating token pattern the n-gram lookup draft must reach a
    high acceptance rate (the prompt-lookup win condition): the greedy
    continuation of a loop-closed model output repeats too. Uses the
    model's own generated loop: generate once, feed output back as the
    prompt — the continuation repeats the cycle the model fell into."""
    from kquant.runtime.speculative import DeviceSpeculator

    target, _ = engines
    seed_out = target.generate([[3, 100, 7]], max_new_tokens=24)[0]
    prompt = [3, 100, 7] + seed_out  # contains the model's own cycle
    want = target.generate([prompt], max_new_tokens=16)
    sp = DeviceSpeculator(target, None, n_draft=4, ngram=2)
    got, stats = sp.generate([prompt], max_new_tokens=16)
    assert got == want
    # the cycle makes lookups land: far fewer rounds than tokens
    assert stats["rounds"] < 16, stats
