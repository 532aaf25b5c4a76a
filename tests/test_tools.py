"""End-to-end tool tests: generate CLI, perplexity, bench table."""

import numpy as np
import pytest

from kquant.models.fixtures import tiny_config, write_fixture_gguf


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("m") / "tool.gguf"
    cfg = tiny_config(n_layers=2, dim=64, n_heads=4, n_kv_heads=2, ffn_dim=128,
                      vocab_size=512, max_seq_len=256)
    write_fixture_gguf(path, cfg, seed=5, quant="q4_k_m", scale=0.08)
    return str(path)


def test_generate_cli(model_path, capsys):
    from kquant.tools.main import main

    out = main(["--model", model_path, "--prompt", "hello world", "-n", "8"])
    assert isinstance(out, str)


def test_perplexity(model_path):
    from kquant.runtime import InferenceEngine, load_model
    from kquant.tools.perplexity import perplexity

    cfg, params, reader = load_model(model_path)
    eng = InferenceEngine(cfg, params, max_batch=1, max_seq=64, impl="xla")
    rng = np.random.default_rng(0)
    stream = rng.integers(3, 500, 200).tolist()
    res = perplexity(eng, stream, ctx=64)
    assert res["tokens"] > 100
    assert 1.0 < res["ppl"] < 1e5  # random model: high but finite
    # fp32-equivalent sanity: ppl should be ~vocab_size for random weights
    assert np.isfinite(res["nll_per_token"])


def test_bench_cli_table(model_path, capsys):
    from kquant.tools.bench_cli import main

    main(["--model", model_path, "-p", "16", "-n", "4", "-r", "2"])
    out = capsys.readouterr().out
    assert "| model |" in out
    assert "pp16" in out and "tg4" in out
    assert "±" in out
