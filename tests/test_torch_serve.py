"""The port's ``BatchServer`` against the JAX package's on the same weights
(reduced Zamba2-7B, Mamba2-130M, Yi-9B, OLMoE-1B-7B and InternVL2-2B):
3 requests, 2 slots (a full wave and a wave of one), prompts of 12 tokens,
greedy decoding.  The token lists must be identical: both servers run the
same steps (the reference's per-slot prefill through decode steps and its
feeding of the last prompt token again at ``pos = maxp`` included), and
their logits differ by float32 rounding only (``test_torch_models.py``), so
a token could differ only where two logits came that close.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from repro.configs.base import get_config as ref_config
from repro.launch import serve as ref_serve
from repro_torch.configs.base import get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve


def _requests(mod, vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [mod.Request(i, rng.integers(0, vocab, 12, dtype=np.int64)
                        .astype(np.int32), max_new=6 + i)
            for i in range(3)]


@pytest.mark.parametrize("arch", ["zamba2-7b", "mamba2-130m", "yi-9b",
                                  "olmoe-1b-7b", "internvl2-2b"])
def test_servers_give_the_same_tokens(arch):
    rcfg = ref_config(arch).reduced()
    ref = ref_serve.BatchServer(rcfg, slots=2, max_seq=32, seed=3)
    cfg = get_config(arch).reduced()
    model = params_from_jax(cfg, jax.tree.map(np.asarray, ref.params), "cpu")
    port = serve.BatchServer(cfg, slots=2, max_seq=32, model=model,
                             device="cpu")
    want = ref.submit_all(_requests(ref_serve, cfg.vocab))
    got = port.submit_all(_requests(serve, cfg.vocab))
    assert got == want
    assert [len(got[i]) for i in range(3)] == [6, 7, 8]
    assert port.stats == ref.stats


@pytest.mark.parametrize("arch", ["mamba2-130m", "yi-9b", "whisper-medium"])
def test_cli_runs_on_the_cpu(capsys, arch):
    assert serve.main(["--arch", arch, "--device", "cpu",
                       "--requests", "2", "--prompt-len", "4", "--gen",
                       "3"]) == 0
    out = capsys.readouterr().out
    assert "2 requests, 6 tokens" in out
    assert ("needs a frames frontend" in out) == (arch == "whisper-medium")
