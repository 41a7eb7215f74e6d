"""The port's examples (``python -m repro_torch.examples.<name>``) run on
the CPU at a small size and report what they promise: an exact Hadamard
factorization, a fitted MEG operator, applies and compositions that
agree with the dense matrix, a chain put into a trained model, a loss
that falls, and every served architecture generating its tokens."""
import numpy as np
import pytest

from repro_torch.configs import ARCH_IDS, get_smoke
from repro_torch.examples import compress_operator, quickstart, serve_lm, train_tiny_lm

CPU = ["--device", "cpu"]


def test_quickstart(capsys):
    out = quickstart.main(CPU)
    assert out["hadamard_re"] < 1e-5  # exact up to f32 rounding
    assert 0 < out["meg_re_spec"] < 0.5
    assert out["apply_err"] < 1e-5 and out["gram_err"] < 1e-5
    assert len(out["batched_re"]) == 4 and all(0 < r < 1 for r in out["batched_re"])
    assert "block_diag operator (512, 1024)" in capsys.readouterr().out


def test_compress_operator(tmp_path):
    rows = compress_operator.main([*CPU, "--steps", "4", "--sweeps", "5", "--ckpt", str(tmp_path)])
    assert [r["k"] for r in rows] == [2, 4]
    k2, k4 = rows
    assert k2["rcg"] > 1 and 0 < k2["re"] < 1 and 0 <= k2["top1_agreement"] <= 1
    # k = 4 keeps every input block of the 64-wide model: the chain is exact
    assert k4["re"] < 1e-4 and k4["logits_rel_err"] < 1e-3 and k4["top1_agreement"] == 1.0


@pytest.mark.parametrize("argv", [[], ["--faust", "--arch", "granite_moe_3b"]], ids=["dense", "faust_moe"])
def test_train_tiny_lm(tmp_path, argv):
    out = train_tiny_lm.main([*CPU, "--steps", "24", "--ckpt", str(tmp_path), *argv])
    losses = [h["loss"] for h in out["history"]]
    assert len(losses) == 24 and np.mean(losses[-10:]) < np.mean(losses[:10])
    assert (out["model"].cfg.faust_mlp is not None) == bool(argv)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_serve_lm(arch, capsys):
    gen, stats = serve_lm.main([*CPU, "--arch", arch, "--batch", "2", "--prompt-len", "16", "--new-tokens", "4"])
    k = get_smoke(arch).n_codebooks  # musicgen: one token a codebook a step
    shape = (2, k, 4) if k > 1 else (2, 4)
    assert gen.shape == shape and stats.tokens_decoded == 8
    assert f"generated {shape} tokens" in capsys.readouterr().out
