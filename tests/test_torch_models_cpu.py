"""Every family of the registry builds and decodes on the CPU in the port
(each is held to the JAX package in ``test_torch_models.py`` and
``test_torch_models_{moe,recurrent}.py``), ``build_model`` needs a card
unless ``device="cpu"`` is asked, and the serving CLI runs on the CPU.
"""
import dataclasses

import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per test process)
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import ARCHS
from repro_torch.launch import serve
from repro_torch.models import build_model, make_batch


def _family_cfg(name):
    """A reduced arch of the registry, or ``"mla"``: the reduced dense
    qwen2.5-14b with DeepSeek-V2's latent attention."""
    if name == "mla":
        return dataclasses.replace(ARCHS["qwen2.5-14b"], use_mla=True,
                                   kv_lora=512, q_lora=1536).reduced()
    return ARCHS[name].reduced()


@pytest.mark.parametrize("name", sorted(n for n in ARCHS
                                        if ARCHS[n].family != "dense")
                         + ["mla"])
def test_every_family_builds_and_decodes_on_the_cpu(name):
    """Every family the registry holds beside the dense one, and MLA on a
    dense decoder: built on the CPU, one forward (with the family's patch
    embeddings or audio frames) and one decode step through a fresh cache,
    each of the expected shape, finite, under inference mode."""
    cfg = _family_cfg(name)
    m = build_model(cfg, device="cpu", seed=1)
    gen = torch.Generator().manual_seed(2)
    s = 16                  # a multiple of the reduced ssm_chunk
    batch = make_batch(cfg, ShapeConfig("t", s, 2, "train"), gen)
    extra = {k: v for k, v in batch.items()
             if k in ("patch_embeds", "frames")}
    assert set(extra) == {"vlm": {"patch_embeds"}, "encdec": {"frames"}}.get(
        cfg.family, set())
    logits = m.forward(batch["tokens"], **extra)
    n = cfg.n_patches if cfg.family == "vlm" else 0
    assert logits.shape == (2, s + n, cfg.vocab)
    assert logits.dtype == torch.bfloat16 and logits.is_inference()
    assert bool(torch.isfinite(logits.float()).all())
    cache = m.init_cache(2, s)
    step, cache2 = m.decode_step(cache, batch["tokens"][:, :1], 0)
    assert cache2 is cache
    assert step.shape == (2, 1, cfg.vocab)
    assert bool(torch.isfinite(step.float()).all())


def test_build_model_needs_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ARCHS["smollm-135m"].reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    m = build_model(cfg, device="cpu", seed=3)
    assert m.device == torch.device("cpu")
    # the same seed gives the same weights; init follows the reference's
    # distributions (unit norms, zero biases, N(0, 1/d_in) projections)
    m2 = build_model(cfg, device="cpu", seed=3)
    for a, b in zip(m.parameters(), m2.parameters()):
        assert torch.equal(a, b)
    blk = m.layers[0]
    assert torch.equal(blk.ln1, torch.ones_like(blk.ln1))
    w = blk.attn.wq.w.float()
    assert abs(w.std().item() * cfg.d_model ** 0.5 - 1) < 0.1
    q = build_model(ARCHS["qwen2.5-14b"].reduced(), device="cpu")
    assert torch.equal(q.layers[0].attn.wk.b,
                       torch.zeros_like(q.layers[0].attn.wk.b))


def test_serve_cli_runs_on_the_cpu(capsys):
    tokens = serve.main(["--arch", "smollm-135m", "--device", "cpu",
                         "--batch", "2", "--prompt-len", "4", "--gen", "5"])
    assert tokens.shape == (2, 5)
    assert ((tokens >= 0) & (tokens < ARCHS["smollm-135m"].reduced().vocab)).all()
    assert "generated (2, 5) tokens" in capsys.readouterr().out
