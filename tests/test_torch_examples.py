"""The port's examples (``repro_torch.examples``) run in process on the CPU
at tiny sizes, each through its ``main`` with ``--device cpu``, and each
passes its own check: the mined cliques equal a plain enumeration, the
resumed and the supervised runs equal the clean one, the trace is valid
and covered by its phase spans. Without a card, the default device
raises. Imports nothing of JAX."""
import pytest
import torch

from repro_torch.core import RunConfig, graph as G, run
from repro_torch.core.apps import MotifsApp
from repro_torch.core.baselines import bruteforce as bf
from repro_torch.examples import (
    cliques, fsm_end_to_end, motifs_distributed, motifs_odag_store,
    quickstart, resume_after_crash, traced_run,
)

torch.set_num_threads(1)

CPU = ["--device", "cpu"]


def test_quickstart(capsys):
    res = quickstart.main(CPU + ["--scale", "0.02"])
    g = G.citeseer_like(scale=0.02)
    assert res.patterns == bf.motif_counts(g, 3)
    assert "pattern nodes=" in capsys.readouterr().out


@pytest.mark.parametrize("scale,size", [(0.00002, 3), (0.000003, 4)])
def test_cliques_match_plain_enumeration(scale, size, capsys):
    mined = cliques.main(CPU + ["--scale", str(scale),
                                "--max-size", str(size)])
    g = G.unlabeled_sn_like(scale=scale)
    assert mined == cliques.enumerate_clique_counts(g, size)
    assert mined == {k: v for k, v in bf.clique_counts(g, size).items()
                     if v}
    assert capsys.readouterr().out.rstrip().endswith("MATCH")


@pytest.mark.parametrize("store", ["raw", "odag"])
def test_fsm_end_to_end(store, capsys):
    res = fsm_end_to_end.main(CPU + ["--scale", "0.02", "--support", "2",
                                     "--store", store])
    g = G.citeseer_like(scale=0.02)
    assert res.patterns == bf.fsm_supports(g, 3, 2)
    out = capsys.readouterr().out
    assert "frequent patterns" in out
    assert ("Fig. 9" in out) == (store == "odag")


@pytest.mark.parametrize("example", [motifs_distributed, motifs_odag_store],
                         ids=["raw", "odag"])
def test_distributed_examples_equal_serial(example, capsys):
    res = example.main(CPU + ["--scale", "0.001", "--workers", "4"])
    serial = run(G.mico_like(scale=0.001), MotifsApp(max_size=3),
                 RunConfig(), device="cpu")
    assert res.patterns == serial.patterns
    assert res.stats.total_embeddings == serial.stats.total_embeddings
    assert "mesh: 4 workers" in capsys.readouterr().out


def test_resume_after_crash(capsys):
    runs = resume_after_crash.main(CPU)
    ref = runs["reference"].patterns
    assert runs["resumed"].patterns == ref
    assert runs["supervised"].patterns == ref
    assert runs["supervised"].recovery["n_retries"] == 1
    assert capsys.readouterr().out.count("OK:") == 2


def test_traced_run(tmp_path, capsys):
    res, cov = traced_run.main(CPU + ["--trace-dir", str(tmp_path),
                                      "--scale", "0.001"])
    assert cov["coverage"] >= traced_run.MIN_COVERAGE
    assert res.trace_path.startswith(str(tmp_path))
    assert "trace valid" in capsys.readouterr().out


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quickstart.main(["--scale", "0.02"])
