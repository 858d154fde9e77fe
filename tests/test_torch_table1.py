"""The Table 1 leg of the port (``repro_torch.bench.table1_accuracy``)
held against the JAX package: its initial-centroid indices equal what
``repro.core.pq.fit`` draws, one (dataset, seed) of the quick grid gives
the reference's per-measure 1-NN errors and Rand indices (decisions
between two candidates within ``TIE_REL`` counted and printed, never
failed), and the leg runs end to end on the CPU.

Regenerate the indices file from JAX with

    PYTHONPATH=src python tests/test_torch_table1.py
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import kmeans as jkmeans
from repro.core.baselines import (cdtw_cdist as j_cdtw, ed_cdist as j_ed,
                                  sax_mindist_cdist as j_sax_d,
                                  sax_transform as j_sax)
from repro.core.baselines import sbd_cdist as j_sbd
from repro.core.cluster import hierarchical_labels as j_hier
from repro.core.dtw import dtw_cdist as j_dtw_cdist
from repro.core.metrics import error_rate as j_err, rand_index as j_ri
from repro.core import pq as jpq
from repro.data.timeseries import make_dataset
from repro_torch.bench import table1_accuracy as leg

CPU = "cpu"
N_SUB = 5


def ref_init_indices(n: int, seed: int, n_sub: int, k: int) -> np.ndarray:
    """``(n_sub, k)`` indices that ``repro.core.pq.fit(PRNGKey(seed), X)``
    draws for subspace m's initial centroids: the reference's own
    ``_init_centroids`` on a column of row numbers."""
    keys = jax.random.split(jax.random.PRNGKey(seed), n_sub)
    rows = jnp.arange(n, dtype=jnp.float32)[:, None]
    return np.stack([np.asarray(jkmeans._init_centroids(keys[m], rows, k))
                     [:, 0].astype(np.int64) for m in range(n_sub)])


def _grid_keys():
    for quick in (True, False):
        g = leg.grid(quick)
        for ds in leg.DATASETS:
            n = make_dataset(ds, g["n_per_class"], 8, seed=0)[0].shape[0]
            for seed in g["seeds"]:
                yield ds, n, seed


def write_init_file(path: str = leg.INIT_PATH) -> None:
    indices = {}
    for ds, n, seed in _grid_keys():
        k = leg.pq_configs(n)[0].codebook_size
        indices[f"{ds}/{n}/{seed}"] = ref_init_indices(
            n, seed, N_SUB, k).tolist()
    with open(path, "w") as f:
        json.dump({"source": "jax.random.choice(jax.random.split("
                             "PRNGKey(seed), M)[m], n, (k,), replace=n < k)"
                             ", as repro.core.pq.fit draws them; written by "
                             "tests/test_torch_table1.py",
                   "n_sub": N_SUB, "codebook_size": "min(48, n)",
                   "indices": indices}, f)
        f.write("\n")


def test_init_file_equals_jax_draws():
    table = leg.load_init()
    keys = {f"{ds}/{n}/{seed}" for ds, n, seed in _grid_keys()}
    assert set(table) == keys
    for key, idx in table.items():
        _, n, seed = key.split("/")
        n, seed = int(n), int(seed)
        k = leg.pq_configs(n)[0].codebook_size
        np.testing.assert_array_equal(np.asarray(idx),
                                      ref_init_indices(n, seed, N_SUB, k))


def test_init_centroids_are_what_fit_starts_from():
    """The indices pick the same rows the reference's ``fit`` starts from
    (its ``_init_centroids`` on the real segments)."""
    import torch
    ds, seed = "gunpoint", 1
    g = leg.grid(True)
    X, _ = make_dataset(ds, g["n_per_class"], g["length"], seed=seed)
    jcfg = jpq.PQConfig(n_sub=5, codebook_size=min(48, X.shape[0]),
                        window_frac=0.1, use_prealign=True, kmeans_iters=4,
                        dba_iters=1)
    segs = np.asarray(jpq.segment(jnp.asarray(X), jcfg))
    keys = jax.random.split(jax.random.PRNGKey(seed), N_SUB)
    want = np.stack([np.asarray(jkmeans._init_centroids(
        keys[m], segs[:, m], jcfg.codebook_size)) for m in range(N_SUB)])
    got = leg.init_centroids(leg.load_init(), ds, seed,
                             torch.from_numpy(segs.copy()),
                             jcfg.codebook_size)
    np.testing.assert_array_equal(got.numpy(), want)


def reference_run(dataset: str, seed: int, n_per_class: int,
                  length: int) -> dict:
    """One (dataset, seed) of ``benchmarks/table1_accuracy.py`` computed
    with the JAX package, its calls as the benchmark makes them (the DTW
    row through ``dtw_cdist(., ., None)``, unsquared there; the order of
    its values is the same)."""
    Xtr, ytr = make_dataset(dataset, n_per_class, length, seed=seed)
    Xte, yte = make_dataset(dataset, n_per_class, length, seed=seed + 100)
    Xtr_j, Xte_j = jnp.asarray(Xtr), jnp.asarray(Xte)
    D = Xtr.shape[1]
    k_classes = len(np.unique(ytr))
    pq_cfg = jpq.PQConfig(n_sub=5, codebook_size=min(48, Xtr.shape[0]),
                          window_frac=0.1, use_prealign=True,
                          kmeans_iters=4, dba_iters=1)
    key = jax.random.PRNGKey(seed)
    cb = jpq.fit(key, Xtr_j, pq_cfg)
    tr_codes = jpq.encode(Xtr_j, cb, pq_cfg)
    te_codes = jpq.encode(Xte_j, cb, pq_cfg)
    te_segs = jpq.segment(Xte_j, pq_cfg)
    d = {"PQDTW": np.asarray(jpq.cdist_sym(te_codes, tr_codes, cb.lut))}
    dtt = {"PQDTW": np.asarray(jpq.cdist_sym_refined(
        te_codes, te_segs, te_codes, te_segs, cb))}
    w5, w10 = max(1, int(0.05 * D)), max(1, int(0.10 * D))
    sax_l = max(2, int(0.2 * length))
    pq_ed_cfg = jpq.PQConfig(n_sub=5, codebook_size=min(48, Xtr.shape[0]),
                             metric="euclidean", use_prealign=False,
                             kmeans_iters=6)
    cb_ed = jpq.fit(key, Xtr_j, pq_ed_cfg)
    tr_ed = jpq.encode(Xtr_j, cb_ed, pq_ed_cfg)
    te_ed = jpq.encode(Xte_j, cb_ed, pq_ed_cfg)
    fns = {"ED": lambda A: j_ed(Xte_j, A),
           "DTW": lambda A: j_dtw_cdist(Xte_j, A, None),
           "cDTW5": lambda A: j_cdtw(Xte_j, A, w5),
           "cDTW10": lambda A: j_cdtw(Xte_j, A, w10),
           "SBD": lambda A: j_sbd(Xte_j, A)}
    for name, fn in fns.items():
        d[name] = np.asarray(fn(Xtr_j))
        dtt[name] = np.asarray(fn(Xte_j))
    Sa = j_sax(Xte, sax_l)
    d["SAX"] = j_sax_d(Sa, j_sax(Xtr, sax_l), length)
    dtt["SAX"] = j_sax_d(Sa, Sa, length)
    d["PQ_ED"] = np.asarray(jpq.cdist_sym(te_ed, tr_ed, cb_ed.lut))
    dtt["PQ_ED"] = np.asarray(jpq.cdist_sym(te_ed, te_ed, cb_ed.lut))
    err = {m: j_err(yte, ytr[np.argmin(d[m], axis=1)]) for m in leg.MEASURES}
    ri = {m: j_ri(yte, j_hier(dtt[m], k_classes)) for m in leg.MEASURES}
    return dict(ytr=ytr, d=d, dtt=dtt, err=err, ri=ri,
                codes={"PQDTW": (np.asarray(tr_codes), np.asarray(te_codes)),
                       "PQ_ED": (np.asarray(tr_ed), np.asarray(te_ed))})


@pytest.fixture(scope="module")
def both_runs():
    g = leg.grid(True)
    ds, seed = "cbf", 0
    ref = reference_run(ds, seed, g["n_per_class"], g["length"])
    port = leg.one_run(ds, seed, g["n_per_class"], g["length"], CPU)
    return ref, port


def test_quick_run_errors_and_rand_indices_equal_reference(both_runs):
    ref, port = both_runs
    res = leg.compare_runs(port, ref)
    print("decisions within TIE_REL that part the two packages:",
          res["ties"])
    assert res["faults"] == [], res
    # every measure agrees where no tie parted the two
    parted = {t["measure"] for t in res["ties"]}
    for m in leg.MEASURES:
        if m not in parted:
            assert port["err"][m] == ref["err"][m], m
            assert port["ri"][m] == ref["ri"][m], m


@pytest.mark.parametrize("name", ["PQDTW", "PQ_ED"])
def test_quick_run_codes_equal_reference(both_runs, name):
    ref, port = both_runs
    for got, want in zip(port["codes"][name], ref["codes"][name]):
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["ED", "DTW", "cDTW5", "cDTW10", "SBD",
                                  "SAX"])
def test_quick_run_baseline_matrices_close(both_runs, name):
    ref, port = both_runs
    want_d, want_tt = ref["d"][name], ref["dtt"][name]
    got_d, got_tt = port["d"][name], port["dtt"][name]
    if name == "DTW":        # the reference's row is the squared cost
        want_d, want_tt = np.sqrt(want_d), np.sqrt(want_tt)
    if name == "ED":
        g = leg.grid(True)
        Xtr, _ = make_dataset("cbf", g["n_per_class"], g["length"], seed=0)
        Xte, _ = make_dataset("cbf", g["n_per_class"], g["length"], seed=100)
        assert leg.ed_close(got_d, want_d, Xte, Xtr)
        assert leg.ed_close(got_tt, want_tt, Xte, Xte)
        return
    np.testing.assert_allclose(got_d, want_d, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got_tt, want_tt, rtol=1e-5, atol=1e-4)


def test_leg_runs_end_to_end(tmp_path, capsys):
    b, runs, seconds = leg.run(quick=True, device=CPU, datasets=["gunpoint"],
                               seeds=[1], out_dir=str(tmp_path))
    rec = json.loads((tmp_path / "hw_cpu_table1_accuracy.json").read_text())
    assert rec["device"] == "cpu" and rec["nvidia_smi"] is None
    assert [r["measure"] for r in rec["rows"]] == list(leg.MEASURES)
    for row in rec["rows"]:
        assert set(row) == {"measure", "mean_err_diff", "std_err_diff",
                            "mean_ri_diff", "speedup_vs_pqdtw",
                            "median_speedup_vs_pqdtw", "mean_err",
                            "mean_ri"}
        assert all(np.isfinite(v) for k, v in row.items() if k != "measure")
    pq = rec["rows"][0]
    assert pq["mean_err_diff"] == 0.0 and pq["speedup_vs_pqdtw"] == 1.0
    assert pq["median_speedup_vs_pqdtw"] == 1.0
    assert len(runs) == 1 and seconds > 0
    assert "measure=PQDTW" in capsys.readouterr().out


def test_compare_runs_counts_ties_and_faults():
    """A flip between two candidates within TIE_REL is a tie; a flip
    between far candidates, a fault."""
    ytr = np.array([0, 1, 2])
    base = np.array([[1.0, 2.0, 3.0]])
    near = np.array([[1.0, 1.0 - 1e-7, 3.0]])
    far = np.array([[1.0, 0.5, 3.0]])
    dtt = np.array([[0.0, 1.0], [1.0, 0.0]])

    def run(d):
        return dict(ytr=ytr, d={m: d for m in leg.MEASURES},
                    dtt={m: dtt for m in leg.MEASURES},
                    err={m: float(ytr[np.argmin(d, 1)][0] != 0)
                         for m in leg.MEASURES},
                    ri={m: 1.0 for m in leg.MEASURES})
    tie = leg.compare_runs(run(base), run(near))
    assert tie["faults"] == [] and len(tie["ties"]) == len(leg.MEASURES)
    fault = leg.compare_runs(run(base), run(far))
    assert len(fault["faults"]) == len(leg.MEASURES)


if __name__ == "__main__":
    write_init_file(sys.argv[1] if len(sys.argv) > 1 else leg.INIT_PATH)
