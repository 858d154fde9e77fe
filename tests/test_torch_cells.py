"""The port's cell layer (``repro_torch.launch.{specs,cells,cost,dryrun}``)
and its two benchmark suites (``bench.memory_cost``, ``bench.roofline``,
``bench.run``) held against the JAX package on the CPU.

* ``specs``: every leaf of the train state, the inputs, the KV / state
  cache and the PQ cache (exact and coded values) has the shape and dtype
  of the reference's ``jax.eval_shape`` leaf at the same field path, for
  every applicable (arch, shape) of the full configs: both sides are
  abstract.  Exact.
* FLOPs: the meta pass over the reduced internlm2-1.8b prefill, train
  (one and two microbatches) and decode cells equals the reference's
  ``analyze_module(...).flops`` of the same cells lowered and compiled on
  the CPU.  Both count each matrix product's ``2 m n k``; the tolerance
  is 0 (equal counts).
* The train FLOPs at the smoke's 8 x 1024 (remat off) against
  ``chip_smoke.py::_train_flops`` for the five configs the smoke trains
  (deepseek-moe-16b at its 2 layers), with the difference itemised: the
  SSD's own products (ssm, hybrid: ``3 x`` a layer's ``ssd_forward``
  FLOPs beyond its projections, on meta), the routed experts at their
  capacity ``C`` (moe: ``18 d f (E C - T k)`` a layer) and the frame
  projection's input gradient, which is never taken (encdec: ``- 2 B S_f
  d^2``).  What is left is within ``SSD_RESIDUAL`` = 0.1%: the SSD's
  first chunk reads the zero initial state, which needs no gradient.
* The meta pass counts SSM projections as the card's bf16 GEMM, and its
  fused floor reads the arguments once and writes what the step writes
  once.
* ``memory_cost``'s rows equal the reference suite's, number for number.
"""

import dataclasses
import importlib.util
import json
from pathlib import Path
from unittest import mock

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AxisType, Mesh

from repro.configs import registry as jreg
from repro.launch import cells as jcells
from repro.launch import specs as jspecs
from repro.launch.hlo_cost import analyze_module
from repro.serve.pqkv import PQKVConfig as JPQ
from repro_torch.bench import roofline as troofline
from repro_torch.bench import run as trun
from repro_torch.configs import registry as treg
from repro_torch.launch import cost, dryrun, specs
from repro_torch.launch.cells import build_cell
from repro_torch.models import layers
from repro_torch.models import ssm as tssm
from repro_torch.models.layers import moe_capacity
from repro_torch.serve.pqkv import PQKVConfig as TPQ

REPO = Path(__file__).resolve().parents[1]
SSD_RESIDUAL = 1e-3
SMALL_PQ = dict(n_sub=4, codebook_size=16, recent_window=8)


def _name(k):
    for a in ("name", "key", "idx"):
        if hasattr(k, a):
            return str(getattr(k, a))
    raise TypeError(k)


def _jax_layout(tree):
    return {"/".join(_name(k) for k in path):
            (tuple(leaf.shape), str(leaf.dtype))
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_layout(tree, cfg):
    return {k: (s, str(d).replace("torch.", ""))
            for k, (s, d) in specs.reference_layout(tree, cfg).items()}


# -- specs --------------------------------------------------------------------

@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
def test_specs_equal_the_reference_eval_shape(arch):
    jc, tc = jreg.get_config(arch), treg.get_config(arch)
    pairs = [("train state", jspecs.abstract_train_state(jc),
              specs.abstract_train_state(tc))]
    for name, jshape in jreg.SHAPES.items():
        if not jreg.shape_applicable(jc, jshape)[0]:
            continue
        tshape = treg.SHAPES[name]
        pairs.append((f"{name} inputs", jspecs.input_specs(jc, jshape),
                      specs.input_specs(tc, tshape)))
        if jshape.kind != "decode":
            continue
        pairs.append((f"{name} cache", jspecs.abstract_cache(jc, jshape),
                      specs.abstract_cache(tc, tshape)))
        if jc.family in ("dense", "moe", "vlm"):
            for qv in (False, True):
                pairs.append((f"{name} pq cache qv={qv}",
                              jspecs.abstract_pq_cache(jc, jshape,
                                                       JPQ(quantize_v=qv)),
                              specs.abstract_pq_cache(tc, tshape,
                                                      TPQ(quantize_v=qv))))
    for what, want, got in pairs:
        assert _port_layout(got, tc) == _jax_layout(want), what
        assert all(t.device.type == "meta"
                   for t in jax.tree_util.tree_leaves(
                       [x for x in _leaves(got)])), what


def _leaves(tree):
    from repro_torch._tree import leaves
    return [t for t in leaves(tree) if isinstance(t, torch.Tensor)]


# -- FLOPs against the reference's HLO count ----------------------------------

def _one_device_mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"),
                axis_types=(AxisType.Auto,) * 2)


@pytest.mark.parametrize("kind,S,B,rows", [
    ("prefill", 64, 2, 1), ("train", 64, 4, 4), ("train", 64, 4, 2),
    ("decode", 64, 2, 1)])
def test_flops_equal_the_reference_hlo_count(kind, S, B, rows):
    arch = "internlm2-1.8b"
    mesh = _one_device_mesh()
    with mock.patch.object(jcells, "get_config", jreg.get_reduced):
        plan = jcells.build_cell(arch, jreg.ShapeSpec("x", S, B, kind), mesh,
                                 microbatch_rows=rows, q_chunk=16)
    want = analyze_module(jcells.lower_cell(plan, mesh).compile().as_text())
    got = cost.count_cell(build_cell(
        arch, treg.ShapeSpec("x", S, B, kind), cfg=treg.get_reduced(arch),
        microbatch_rows=rows, q_chunk=16))
    assert got.flops == want.flops
    assert got.flops_bf16 > 0 and got.flops_f32 > 0    # both types counted


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ssd_products(cfg, B, S):
    """FLOPs of one ``ssd_forward`` beyond its projections, on meta."""
    with specs.meta_factories():
        p = tssm.init_ssm(torch.Generator(), cfg, specs.META, torch.float32)
    x = torch.empty((B, S, cfg.d_model), dtype=torch.bfloat16, device="meta")
    counter = cost.CostCounter()
    with counter:
        tssm.ssd_forward(p, cfg, x)
    d, din, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    proj = 2 * B * S * d * (2 * din + 2 * N + H) + 2 * B * S * din * d
    return counter.cost.flops - proj


@pytest.mark.parametrize("arch,layers", [
    ("internlm2-1.8b", None), ("mamba2-780m", None), ("zamba2-2.7b", None),
    ("seamless-m4t-large-v2", None), ("deepseek-moe-16b", 2)])
def test_train_flops_equal_the_smoke_formula(arch, layers):
    B, S = 8, 1024
    cfg = treg.get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    got = cost.count_cell(build_cell(
        arch, treg.ShapeSpec("s", S, B, "train"), cfg=cfg,
        microbatch_rows=B, remat=False, q_chunk=512)).flops
    want = _chip_smoke()._train_flops(cfg, specs.abstract_params(cfg), B,
                                      S)["model_flops"]
    T = B * S
    if cfg.family in ("ssm", "hybrid"):
        extra = 3 * cfg.n_layers * _ssd_products(cfg, B, S)
        assert extra > 0.02 * want           # the SSD's share is itemised
        assert abs(got / (want + extra) - 1) < SSD_RESIDUAL
        return
    if cfg.family == "moe":
        C = moe_capacity(cfg, T)
        extra = (cfg.n_layers * 18 * cfg.d_model * cfg.moe_d_ff
                 * (cfg.n_experts * C - T * cfg.n_active_experts))
    elif cfg.family == "encdec":
        extra = -2 * B * cfg.n_frontend_tokens * cfg.d_model ** 2
    else:
        extra = 0
    assert got == want + extra


# -- the meta pass -----------------------------------------------------------

@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-2.7b"])
def test_ssm_projections_count_as_the_cards_bf16_product(arch):
    """``_dot_f32`` takes the card's form on meta tensors: one bf16 GEMM
    writing float32 (``mm`` with ``out_dtype``), no float32 copies of its
    operands.  So every forward projection of an SSM layer lands in
    ``flops_bf16``, as on the card."""
    x = torch.empty((128, 64), dtype=torch.bfloat16, device="meta")
    w = torch.empty((64, 32), dtype=torch.float32, device="meta")
    counter = cost.CostCounter()
    counter.hold((x, w))
    with counter:
        y = layers._dot_f32(x, w)
    assert y.dtype == torch.float32
    got = counter.cost
    assert (got.flops_bf16, got.flops_f32) == (2 * 128 * 64 * 32, 0)
    # w's bf16 cast, then the product: no float32 upcast of x or w
    assert got.hbm_bytes == (64 * 32 * (4 + 2)
                             + 128 * 64 * 2 + 64 * 32 * 2 + 128 * 32 * 4)

    cfg = treg.get_reduced(arch)
    B, S = 2, 64
    cell = cost.count_cell(build_cell(
        arch, treg.ShapeSpec("p", S, B, "prefill"), cfg=cfg))
    d, din, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    proj = 2 * B * S * d * (2 * din + 2 * N + H) + 2 * B * S * din * d
    assert cell.flops_bf16 >= cfg.n_layers * proj

def test_pq_decode_counts_row_11_as_one_op_a_layer():
    """The PQ decode cell reaches ``pq_attn`` on meta tensors: one op a
    layer, charged its operands' and outputs' bytes; its plain version's
    gather never runs."""
    cfg = treg.get_reduced("internlm2-1.8b")
    pqc = TPQ(**SMALL_PQ)
    B, S = 2, 64
    plan = build_cell("internlm2-1.8b", treg.ShapeSpec("d", S, B, "decode"),
                      cfg=cfg, extra={"pqkv": pqc})
    ops = set()

    class Seen(cost.CostCounter):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ops.add(func.overloadpacket.__name__)
            return super().__torch_dispatch__(func, types, args, kwargs)

    counter = Seen()
    counter.hold(plan.abstract_args)
    with counter:
        plan.fn(*plan.abstract_args)
    got = counter.cost
    assert "gather" not in ops and "mm" in ops
    assert got.kernels == {"pq_attn": cfg.n_layers}
    G, M, K, hd = cfg.n_kv_heads, pqc.n_sub, pqc.codebook_size, cfg.head_dim_
    H = cfg.n_heads
    # a bf16 query table, uint8 codes, bf16 values; float32 outputs
    per_layer = (B * H * M * K * 2 + B * S * G * M + B * S * G * hd * 2
                 + B * H * hd * 4 + 2 * B * H * 4)
    assert got.kernel_bytes == cfg.n_layers * per_layer
    exact = cost.count_cell(build_cell(
        "internlm2-1.8b", treg.ShapeSpec("d", S, B, "decode"), cfg=cfg))
    assert exact.kernels == {}


def test_the_fused_floor_reads_arguments_once():
    """``floor_bytes`` is the least the step can move: its arguments read
    once, each region it writes written once (the train step's weights
    and moments through AdamW, a decode step's K and V slot a layer) and its
    new outputs (the last-position logits) once.  The eager traffic is
    larger, and the roofline's memory term is the floor's."""
    cfg = treg.get_reduced("internlm2-1.8b")
    B, S = 2, 64

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in _leaves(tree))

    train = build_cell("internlm2-1.8b", treg.ShapeSpec("t", S, 2 * B,
                                                        "train"),
                       cfg=cfg, microbatch_rows=B, q_chunk=16)
    got = cost.count_cell(train)
    state = train.abstract_args[0]
    assert got.argument_bytes == nbytes(train.abstract_args)
    assert got.written_bytes == (nbytes(state.params) + nbytes(state.opt.mu)
                                 + nbytes(state.opt.nu))
    assert got.output_bytes == nbytes(state.opt.count)     # the new count
    assert got.floor_bytes < got.hbm_bytes

    decode = build_cell("internlm2-1.8b", treg.ShapeSpec("d", S, B,
                                                         "decode"), cfg=cfg)
    got = cost.count_cell(decode)
    slot = B * cfg.n_kv_heads * cfg.head_dim_ * 2           # bf16
    assert got.argument_bytes == nbytes(decode.abstract_args)
    assert got.written_bytes == cfg.n_layers * 2 * slot
    assert got.output_bytes == B * cfg.vocab_size * 4      # float32 logits
    ro = cost.roofline(got, model_flops=1.0)
    assert ro.hbm_bytes == got.floor_bytes
    assert ro.hbm_eager_bytes == got.hbm_bytes > got.floor_bytes
    assert ro.memory_s == got.floor_bytes / cost.H100.hbm_bw


def test_peak_keeps_what_autograd_saves():
    """The simulated allocator frees a storage only when it dies: tanh's
    output, saved for its backward, stays counted until the backward."""
    w = torch.empty((64, 64), device="meta", requires_grad=True)
    x = torch.empty((8, 64), device="meta")
    counter = cost.CostCounter()
    counter.hold((w, x))
    with counter:
        h = torch.tanh(x @ w)            # mm's output dies, h is saved
        loss = torch.sin(h).sum()
        del h
        live_before_backward = counter._bytes
        loss.backward()
    args = 64 * 64 * 4 + 8 * 64 * 4
    assert counter.cost.argument_bytes == args
    # h (saved by tanh and by sin) and the loss; mm's output is gone
    assert live_before_backward == args + 8 * 64 * 4 + 4
    assert counter.cost.peak_bytes >= args + 2 * 8 * 64 * 4


def test_meta_factories_allocate_nothing():
    cfg = treg.get_config("qwen2-72b")
    state = specs.abstract_train_state(cfg)
    assert {t.device.type for t in _leaves(state)} == {"meta"}
    n = sum(t.numel() for t in _leaves(state.params))
    # param_count leaves out the norm scales and biases (2.1 M here)
    assert 0 <= n - cfg.param_count() < 1e-4 * n


# -- dryrun, roofline and the runner ------------------------------------------

def test_dryrun_writes_one_record_a_cell(tmp_path, capsys):
    out = str(tmp_path / "dry")
    argv = ["--out", out, "--shape", "long_500k"]
    assert dryrun.main(argv + ["--arch", "mamba2-780m"]) == 0
    assert dryrun.main(["--out", out, "--arch", "internlm2-1.8b",
                        "--shape", "decode_32k"]) == 0
    recs = {p.name: json.loads(p.read_text())
            for p in Path(out).glob("*.json")}
    assert sorted(recs) == ["internlm2-1.8b__decode_32k__card.json",
                            "mamba2-780m__long_500k__card.json"]
    small = recs["mamba2-780m__long_500k__card.json"]
    big = recs["internlm2-1.8b__decode_32k__card.json"]
    assert small["fit"] and not big["fit"]
    assert "> 80 GiB" in big["fit_reason"]
    for r in (small, big):
        ro = r["roofline"]
        assert ro["flops"] == ro["flops_bf16"] + ro["flops_f32"] \
            + ro["flops_other"]
        assert ro["hbm_bytes"] > 0 and ro["bound"] in ("compute", "memory")
        assert ro["collective_s"] == 0 and r["chips"] == 1
        assert r["memory"]["peak_bytes"] >= r["memory"]["argument_bytes"]
    # a record that exists is read back, not counted again
    capsys.readouterr()
    with mock.patch.object(dryrun, "_count") as count:
        dryrun.main(argv + ["--arch", "mamba2-780m"])
    assert not count.called
    # a real step is the card's alone; a mesh name outside the four raises
    for mesh in (["--mesh", "multi", "--run"], ["--mesh", "pod"]):
        with pytest.raises(SystemExit):
            dryrun.main(argv + ["--arch", "mamba2-780m", *mesh])


def test_dryrun_train_record_states_16_bytes_a_parameter(tmp_path):
    rec = dryrun.run_cell("qwen2-72b", "train_4k", str(tmp_path),
                          extra={"global_batch": 2})
    cfg = treg.get_config("qwen2-72b")
    assert rec["state_bytes"] == 16 * cfg.param_count()
    assert not rec["fit"] and "train state alone" in rec["fit_reason"]
    assert rec["reduced"] == ["global_batch 256 -> 2"]
    assert rec["microbatches"] == 2


@pytest.mark.parametrize("kind", ["train", "prefill", "decode", "pq"])
def test_real_step_runs_each_kind(kind):
    """``--run``'s real step (made arguments, one step, the peak) on the
    reduced config on the CPU; on the card it also reads the peak."""
    cfg = treg.get_reduced("internlm2-1.8b")
    extra = {"train": {"microbatch_rows": 2}, "pq": {
        "pqkv": TPQ(**SMALL_PQ)}}.get(kind)
    shape = treg.ShapeSpec("x", 32, 4, "decode" if kind == "pq" else kind)
    seconds, peak = dryrun.real_step("internlm2-1.8b", shape, extra, "cpu",
                                     cfg=cfg)
    assert seconds > 0 and peak is None


def test_roofline_reads_the_dryrun_records(tmp_path):
    records = tmp_path / "dry"
    for arch, shape in (("mamba2-780m", "long_500k"),
                        ("mamba2-780m", "decode_32k")):
        dryrun.run_cell(arch, shape, str(records))
    bench = troofline.run(device="cpu", out_dir=str(tmp_path / "out"),
                          records_dir=str(records))
    assert [(r["arch"], r["shape"]) for r in bench.rows] == [
        ("mamba2-780m", "decode_32k"), ("mamba2-780m", "long_500k")]
    table = (tmp_path / "out" / "roofline_table.md").read_text()
    assert table.count("| mamba2-780m |") == 2
    saved = json.loads((tmp_path / "out" / "hw_cpu_roofline.json")
                       .read_text())
    assert saved["records"] == 2 and saved["device"] == "cpu"


def test_memory_cost_rows_equal_the_reference_suite(tmp_path, monkeypatch):
    monkeypatch.syspath_prepend(str(REPO))
    from benchmarks import common as jcommon
    from benchmarks import memory_cost as jmemory
    monkeypatch.setattr(jcommon.Bench, "save", lambda self, *a, **k: None)
    want = jmemory.run().rows
    trun.main(["--only", "memory", "--device", "cpu", "--out",
               str(tmp_path)])
    got = json.loads((tmp_path / "hw_cpu_memory_cost.json").read_text())
    assert got["rows"] == want
    assert [p.name for p in tmp_path.iterdir()] == ["hw_cpu_memory_cost.json"]


def test_run_lists_the_ported_suites():
    assert set(trun.SUITES) == {"table1", "fig5a", "fig5b", "fig5c",
                                "serving", "memory", "roofline"}
    with pytest.raises(SystemExit):
        trun.main(["--only", "memory", "--full", "--smoke"])
