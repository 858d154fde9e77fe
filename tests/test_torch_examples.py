"""The port's examples (``repro_torch.examples``) run on the CPU and
print their tables, at their own sizes; ``nn_classification`` under dtw
(the LB-pruned search) and erp (the dense path); ``index_service`` as a
lifecycle loop and through the serving core (``--serve``).

The two LM examples are held against the reference's launchers on the
CPU.  The reference's launchers build their host mesh with
``jax.make_mesh``, whose axes are ``Explicit`` under this JAX (0.9; the
reference pins < 0.5), and its sharding constraints then raise; these
tests hand them a one-device mesh with ``Auto`` axes, the layout they
were written for.

* ``serve_pqkv`` with the reference launcher's weights, prompts and PQ
  codebooks (its ``init_params`` draws, ``jax.random.randint`` prompts
  and ``compress_cache`` books carried over): the same exact and PQ-KV
  greedy tokens, or where the two part, a near-tie there: both top-2
  logit gaps below ``2 * LOGIT_ATOL`` (two logits each within the LM
  tests' 2e-2), later tokens following other histories.
* ``train_lm`` at ``TRAIN_STEPS`` steps: phase 2 resumes from phase 1's
  checkpoint, logs each step once, and its first loss continues phase
  1's curve (nearer its last loss than its first).
* ``test_train_lm_curve_matches_the_reference`` (marked slow, about 35
  s): the example's 200 steps, port and reference from the reference's
  initial parameters through both launchers, each preempted half-way
  and restarted: every logged loss within ``CURVE_ATOL`` = 2e-3 of the
  reference's (3e-4 at worst here), and the largest rise from one step
  to the next printed for both (whether the reference spikes where the
  port does).
"""

import json
from unittest import mock

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AxisType, Mesh

from repro.configs import registry as jregistry
from repro.launch import serve as jserve
from repro.launch import train as jtrain
from repro.train import step as jstep
from repro_torch import obs
from repro_torch.examples import (clustering, index_service,
                                  nn_classification, quickstart,
                                  serve_pqkv, train_lm)
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import lm as tlm
from repro_torch.train import step as tstep
from repro_torch.train.optim import adamw_init

LOGIT_ATOL = 2e-2
TRAIN_STEPS = 40
CURVE_ATOL = 2e-3


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
    for mod in (quickstart, clustering, nn_classification, index_service,
                serve_pqkv, train_lm):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main([])


def _auto_mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"),
                axis_types=(AxisType.Auto,) * 2)


def _reference_serve():
    """The reference launcher at the example's arguments: its greedy
    tokens (exact, PQ), parameters, prompt and key codebooks."""
    seen = {"greedy": []}
    greedy, init, compress = (jserve.greedy, jserve.init_params,
                              jserve.compress_cache)

    def rec_greedy(logits):
        tok = greedy(logits)
        seen["greedy"].append(np.asarray(tok))
        return tok

    def rec_init(key, cfg):
        seen["params"] = jax.tree.map(np.asarray, init(key, cfg))
        return init(key, cfg)

    def rec_compress(*a, **k):
        out = compress(*a, **k)
        seen["books"] = np.asarray(out.k_books)
        return out

    with mock.patch.object(jserve, "make_host_mesh", _auto_mesh), \
            mock.patch.object(jserve, "greedy", rec_greedy), \
            mock.patch.object(jserve, "init_params", rec_init), \
            mock.patch.object(jserve, "compress_cache", rec_compress):
        jserve.main(list(serve_pqkv.ARGS))
    g = seen["greedy"]
    cfg = jregistry.get_reduced("internlm2-1.8b")
    B, S = 4, 32
    seen["prompt"] = np.asarray(jax.random.randint(
        jax.random.PRNGKey(0), (B, S), 0, cfg.vocab_size, np.int32))
    seen["tokens"] = np.concatenate([g[0]] + g[1::2], axis=1)
    seen["pq_tokens"] = np.concatenate([g[0]] + g[2::2], axis=1)
    return seen


def test_serve_pqkv_gives_the_reference_launchers_tokens(capsys):
    ref = _reference_serve()
    compress = tserve.compress_cache

    def with_books(*a, **k):
        k["books"] = torch.from_numpy(ref["books"].copy())
        return compress(*a, **k)

    with mock.patch.object(tserve, "init_params",
                           lambda cfg, gen, device: tlm.params_from_numpy(
                               ref["params"], cfg, device)), \
            mock.patch.object(tserve, "random_prompt",
                              lambda cfg, b, n, gen: torch.from_numpy(
                                  ref["prompt"].copy())), \
            mock.patch.object(tserve, "compress_cache", with_books):
        got = serve_pqkv.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "[serve] PQ-KV: exact" in out and "agreement" in out
    for key, gaps in (("tokens", "margins"), ("pq_tokens", "pq_margins")):
        want = torch.from_numpy(ref[key]).to(torch.int32)
        assert got[key].shape == want.shape == (4, 12)
        diff = (got[key] != want).nonzero()
        if diff.numel():
            step = int(diff[:, 1].min())
            row = int(diff[diff[:, 1] == step][0, 0])
            assert float(got[gaps][row, step]) < 2 * LOGIT_ATOL, (key, step)


def test_train_lm_curve_continues_across_the_restart(tmp_path, capsys):
    rows = train_lm.main(["--steps", str(TRAIN_STEPS), "--ckpt-dir",
                          str(tmp_path / "ck"), "--device", "cpu"])
    out = capsys.readouterr().out
    half = TRAIN_STEPS // 2
    assert f"restored step {half} from" in out
    assert [r["step"] for r in rows] == list(range(1, TRAIN_STEPS + 1))
    first, before, after = (rows[0]["loss"], rows[half - 1]["loss"],
                            rows[half]["loss"])
    assert abs(after - before) < abs(after - first)
    assert rows[-1]["loss"] < first


def _curves(tmp_path, steps):
    """The example's two phases through both launchers from the
    reference's initial parameters; their logged records."""
    jcfg = jregistry.get_reduced("internlm2-1.8b")
    p0 = jax.tree.map(np.asarray, jstep.init_train_state(
        jax.random.PRNGKey(0), jcfg).params)

    def port_init(generator, cfg, device=None):
        params = tlm.params_from_numpy(p0, cfg, device, dtype=torch.float32)
        return tstep.TrainState(step=torch.zeros((), dtype=torch.int32),
                                params=params, opt=adamw_init(params))

    def run(main, folder, extra=()):
        folder.mkdir()
        metrics = folder / "metrics.jsonl"
        common = ["--arch", "internlm2-1.8b", "--reduced", "--batch", "8",
                  "--seq", "128", "--microbatches", "2", "--ckpt-dir",
                  str(folder), "--ckpt-every", "25", "--metrics-out",
                  str(metrics), *extra]
        main(common + ["--steps", str(steps // 2)])
        main(common + ["--steps", str(steps)])
        return [json.loads(line) for line in metrics.open()]

    with mock.patch.object(jtrain, "make_host_mesh", _auto_mesh):
        ref = run(jtrain.main, tmp_path / "ref")
    with mock.patch.object(ttrain, "init_train_state", port_init):
        port = run(ttrain.main, tmp_path / "port", ("--device", "cpu"))
    return ref, port


def _largest_rise(rows):
    losses = [r["loss"] for r in rows]
    return max((b - a, i + 2) for i, (a, b) in enumerate(zip(losses,
                                                             losses[1:])))


@pytest.mark.slow
def test_train_lm_curve_matches_the_reference(tmp_path, capsys):
    ref, port = _curves(tmp_path, 200)
    capsys.readouterr()
    assert [r["step"] for r in port] == [r["step"] for r in ref] == list(
        range(1, 201))
    gaps = [abs(a["loss"] - b["loss"]) for a, b in zip(ref, port)]
    with capsys.disabled():
        print(f"\ntrain_lm curves, 200 steps: largest |port - reference| "
              f"{max(gaps):.4g}; largest rise from one step to the next "
              f"(loss, step): reference {_largest_rise(ref)}, port "
              f"{_largest_rise(port)}; loss {ref[0]['loss']} -> "
              f"{ref[-1]['loss']} (reference), {port[0]['loss']} -> "
              f"{port[-1]['loss']} (port)")
    assert max(gaps) <= CURVE_ATOL
