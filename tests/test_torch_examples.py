"""The port's examples (``repro_torch.examples``) run on the CPU and
print their tables, at their own sizes; ``nn_classification`` under dtw
(the LB-pruned search) and erp (the dense path); ``index_service`` as a
lifecycle loop and through the serving core (``--serve``)."""

import pytest
import torch

from repro_torch import obs
from repro_torch.examples import (clustering, index_service,
                                  nn_classification, quickstart)


def test_quickstart_runs(capsys):
    quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "dataset: 60 series of length 128 on cpu" in out
    assert "codes: (60, 4) torch.int32" in out
    assert "symmetric  vs exact DTW" in out and "asymmetric vs exact" in out
    acc = float(out.split("symmetric PQDTW: ")[1].split("%")[0])
    assert acc > 50.0


def test_clustering_runs(capsys):
    clustering.main(["--device", "cpu"])
    out = capsys.readouterr().out
    rows = [line.split() for line in out.splitlines()
            if line.startswith(("exact DTW", "PQDTW "))]
    assert len(rows) == 3
    for row in rows:
        ri, ari, sec = map(float, row[-3:])
        assert 0.0 <= ri <= 1.0 and -1.0 <= ari <= 1.0 and sec >= 0.0
    assert "zero symmetric distances" in out


@pytest.mark.parametrize("argv,pruned", [
    ([], True),
    (["--measure", "erp:g=0.5"], False),
])
def test_nn_classification_runs(capsys, argv, pruned):
    nn_classification.main(["--device", "cpu"] + argv)
    out = capsys.readouterr().out
    assert f"LB cascade: {'yes' if pruned else 'no'}" in out
    for name in ("PQ sym", "PQ asym", "NN exact", "NN LB-pruned"):
        line = next(l for l in out.splitlines() if l.startswith(name + " "))
        acc = float(line.split()[-2].rstrip("%"))
        assert 0.0 <= acc <= 100.0
    exact = next(l for l in out.splitlines() if l.startswith("NN exact"))
    lb = next(l for l in out.splitlines() if l.startswith("NN LB-pruned"))
    assert exact.split()[-2] == lb.split()[-2]   # pruning keeps the answer


def test_index_service_runs(capsys):
    index_service.main(["--device", "cpu", "--iters", "6"])
    out = capsys.readouterr().out
    assert "bootstrap: n_lists=8 hot_capacity=64 measure=dtw on cpu" in out
    assert "search identical: True" in out
    assert "sharded planner agrees with single-device search" in out
    assert "index service obs summary" in out
    assert not obs.enabled()


def test_index_service_serve_runs(capsys):
    index_service.main(["--device", "cpu", "--serve", "--iters", "6"])
    out = capsys.readouterr().out
    assert "serve: warmed 4 query buckets" in out
    line = next(l for l in out.splitlines() if " requests / " in l)
    assert int(line.split(" requests / ")[1].split()[0]) > 0
    assert "6 ingest rounds, 0 shed" in line
    assert "serving obs summary" in out and "serving.batch_search" in out


def test_examples_need_a_card_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mod in (quickstart, clustering, nn_classification, index_service):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main([])
