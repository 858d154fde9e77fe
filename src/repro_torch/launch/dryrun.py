"""Dry run: count every (arch x shape) cell on meta tensors, on one card or
per device of a production mesh, and optionally take one real step on
the card (counterpart of :mod:`repro.launch.dryrun`).

For each cell it builds the step and its abstract arguments
(:mod:`.cells`), counts FLOPs by operand type, HBM bytes and the peak of
a simulated allocator on meta tensors (:mod:`.cost`), and writes one JSON
record: whether the cell fits one 80 GiB card and why, the roofline terms
against the H100's rates (the memory term the fused floor's, the eager
step's traffic beside it), and for a train cell its state at 16 bytes a
parameter (float32 masters, two moments and gradients).  Nothing is
allocated on a device and no card is needed.

``--run`` also takes one real step on the card for every cell whose meta
peak leaves 10% of the card free: seeded random weights and inputs, one
warm-up step, then the step timed between synchronizes,
``torch.cuda.max_memory_allocated`` beside
the meta estimate.  A train cell's real step is cut to 2 microbatches of
its own shape (listed under ``run.reduced``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mamba2-780m \\
        --shape prefill_32k --run

``--mesh`` takes the reference's choices with the reference's meanings,
and ``card``: ``card`` (the default) counts the cell on one card as above;
``single`` the 16 x 16 mesh over ``("data", "model")``, 256 devices;
``multi`` the 2 x 16 x 16 mesh over ``("pod", "data", "model")``, 512
devices; ``both`` runs ``single`` and ``multi``.  On a mesh the cell's
arguments are ``DTensor`` s laid out by the partition rules and the step
runs on rank 0's shards under a fake process group of the mesh's size
(:func:`.cost.fake_group`): no device is used.  The record is per
device, as the reference's: ``memory`` (arguments, temporaries, peak),
``cost``, ``collectives`` (bytes by kind, the reference's ring
conventions), ``forced`` (every gather the port inserts or ``DTensor``
chose, with its op, tensor and bytes) and ``roofline`` (the collective
term at :data:`.cost.H100`'s NVLink rate), ``chips`` the mesh's size.  A
cell that fails keeps its ``error``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

Records go to ``--out`` (default ``build/dryrun`` at the repository root,
or ``$REPRO_TORCH_DRYRUN_OUT``), named ``<arch>__<shape>__<mesh>``; a
cell with a record is skipped unless ``--force``; ``--jobs N`` counts
cells in N processes.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from pathlib import Path
from typing import Optional

import torch

from ..configs.registry import ARCH_IDS, SHAPES, ShapeSpec, all_cells
from .cells import CellPlan, build_cell
from .cost import H100, count_cell, model_flops_per_step, roofline

__all__ = ["DRYRUN_DIR", "HEADROOM", "STATE_BYTES_PER_PARAM", "MESHES",
           "cell_id", "run_cell", "real_step", "main"]

DRYRUN_DIR = os.environ.get(
    "REPRO_TORCH_DRYRUN_OUT",
    str(Path(__file__).resolve().parents[3] / "build" / "dryrun"))
HEADROOM = 0.10              # --run: the meta peak leaves this share free
STATE_BYTES_PER_PARAM = 16   # float32 masters, mu, nu and gradients
RUN_MICROBATCHES = 2         # --run: a train cell's real step
# --mesh: None is one card; else make_production_mesh(multi_pod=...)
MESHES = {"card": None, "single": False, "multi": True}


def cell_id(arch: str, shape: str, mesh_name: str = "card") -> str:
    return f"{arch}__{shape}__{mesh_name}"


def _tokens(shape: ShapeSpec) -> int:
    return shape.global_batch * (1 if shape.kind == "decode"
                                 else shape.seq_len)


def _fit(peak: int, state: Optional[int]) -> tuple:
    cap = H100.hbm_bytes
    gib = 2 ** 30
    if peak <= cap:
        return True, f"peak {peak / gib:.2f} GiB <= {cap / gib:.0f} GiB"
    why = f"peak {peak / gib:.2f} GiB > {cap / gib:.0f} GiB"
    if state is not None and state > cap:
        why += (f"; the train state alone ({STATE_BYTES_PER_PARAM} B a "
                f"parameter) is {state / gib:.2f} GiB")
    return False, why


def run_cell(arch: str, shape_name: str, out_dir: str = DRYRUN_DIR,
             force: bool = False, extra: Optional[dict] = None,
             tag: str = "", run: bool = False, device: str = "cuda",
             seed: int = 0, mesh_name: str = "card") -> dict:
    """Count one cell on ``mesh_name`` (:data:`MESHES`; with ``run``, on
    the card, take its real step); returns and writes the record."""
    shape = SHAPES[shape_name]
    cid = cell_id(arch, shape_name, mesh_name) + (f"__{tag}" if tag else "")
    path = os.path.join(out_dir, cid + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            rec = json.load(f)
        if not run or "run" in rec:
            return rec
    elif mesh_name != "card":
        rec = _count_mesh(arch, shape, extra, tag, mesh_name)
    else:
        rec = _count(arch, shape, extra, tag)
    if run and rec["ok"] and mesh_name == "card":
        if rec["memory"]["peak_bytes"] <= (1 - HEADROOM) * H100.hbm_bytes:
            rec["run"] = _run_record(arch, shape, extra, device, seed,
                                     rec["memory"]["peak_bytes"])
        else:
            rec["run"] = {"skipped": f"meta peak leaves under "
                                     f"{HEADROOM:.0%} of the card free"}
    os.makedirs(out_dir, exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def _count(arch: str, shape: ShapeSpec, extra, tag: str) -> dict:
    rec = {"arch": arch, "shape": shape.name, "mesh": "card", "chips": 1,
           "tag": tag, "hw": dataclasses.asdict(H100), "ok": False}
    t0 = time.time()
    try:
        plan = build_cell(arch, shape, extra=extra)
        cfg = plan.cfg
        if plan.shape.global_batch != shape.global_batch:
            rec["reduced"] = [f"global_batch {shape.global_batch} -> "
                              f"{plan.shape.global_batch}"]
        shape = plan.shape
        t_build = time.time() - t0
        cost = count_cell(plan)
        mf = model_flops_per_step(cfg.param_count(),
                                  cfg.active_param_count(), _tokens(shape),
                                  shape.kind)
        state = (STATE_BYTES_PER_PARAM * cfg.param_count()
                 if shape.kind == "train" else None)
        fit, why = _fit(cost.peak_bytes, state)
        rec.update(
            ok=True, t_build_s=round(t_build, 2),
            t_count_s=round(time.time() - t0 - t_build, 2),
            microbatches=plan.microbatches,
            memory=dict(argument_bytes=cost.argument_bytes,
                        temp_bytes=cost.peak_bytes - cost.argument_bytes,
                        peak_bytes=cost.peak_bytes),
            fit=fit, fit_reason=why, state_bytes=state,
            cost=cost.to_dict(),
            roofline=roofline(cost, model_flops=mf).to_dict(),
            params=int(cfg.param_count()),
            active_params=int(cfg.active_param_count()))
    except Exception as e:                                  # noqa: BLE001
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    rec["wall_s"] = round(time.time() - t0, 2)
    return rec


def _count_mesh(arch: str, shape: ShapeSpec, extra, tag: str,
                mesh_name: str) -> dict:
    """One cell counted per device of a production mesh (module
    docstring), under a fake process group of its size."""
    from .cost import fake_group
    from .mesh import make_production_mesh
    desc = make_production_mesh(multi_pod=MESHES[mesh_name])
    rec = {"arch": arch, "shape": shape.name, "mesh": mesh_name,
           "mesh_shape": list(desc.dims), "axes": list(desc.axis_names),
           "chips": desc.size, "tag": tag, "hw": dataclasses.asdict(H100),
           "ok": False}
    t0 = time.time()
    try:
        with fake_group(desc) as mesh:
            plan = build_cell(arch, shape, mesh, extra=extra)
            cfg = plan.cfg
            t_build = time.time() - t0
            cost = count_cell(plan)
        mf = model_flops_per_step(cfg.param_count(),
                                  cfg.active_param_count(), _tokens(shape),
                                  shape.kind)
        fit, why = _fit(cost.peak_bytes, None)
        rec.update(
            ok=True, t_build_s=round(t_build, 2),
            t_count_s=round(time.time() - t0 - t_build, 2),
            microbatches=plan.microbatches,
            memory=dict(argument_bytes=cost.argument_bytes,
                        temp_bytes=cost.peak_bytes - cost.argument_bytes,
                        peak_bytes=cost.peak_bytes),
            fit=fit, fit_reason=why, cost=cost.to_dict(),
            collectives={k: int(v) for k, v in cost.collectives.items()},
            forced=sorted(({"tensor": k, **v} for k, v in
                           cost.forced.items()),
                          key=lambda r: -r["bytes"]),
            roofline=roofline(cost, cost.coll_bytes, desc.size,
                              model_flops=mf).to_dict(),
            params=int(cfg.param_count()),
            active_params=int(cfg.active_param_count()))
    except Exception as e:                                  # noqa: BLE001
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    rec["wall_s"] = round(time.time() - t0, 2)
    return rec


def _run_shape(shape: ShapeSpec, plan: CellPlan) -> tuple:
    """A train cell's real step: 2 microbatches of its own rows."""
    if shape.kind != "train":
        return shape, {}, []
    rows = shape.global_batch // plan.microbatches
    cut = ShapeSpec(shape.name, shape.seq_len, RUN_MICROBATCHES * rows,
                    "train")
    return cut, {"microbatch_rows": rows}, [
        f"global_batch {shape.global_batch} -> {cut.global_batch} "
        f"({RUN_MICROBATCHES} microbatches of {rows} x {shape.seq_len})"]


def _run_record(arch, shape, extra, device, seed, meta_peak) -> dict:
    """The real step's record.  A train cell cut to 2 microbatches keeps
    the microbatch's shape, so its meta peak is the cell's less the batch
    rows it drops (arguments, counted once)."""
    plan = build_cell(arch, shape, extra=extra)
    shape = plan.shape
    cut, over, reduced = _run_shape(shape, plan)
    run_extra = {k: v for k, v in dict(extra or {}, **over).items()
                 if k != "global_batch"}
    if cut is not shape:
        dropped = sum(t.numel() * t.element_size()
                      for t in plan.abstract_args[1].values())
        meta_peak -= dropped * (1 - cut.global_batch / shape.global_batch)
    try:
        seconds, peak = real_step(arch, cut, run_extra, device, seed)
    except Exception as e:                                  # noqa: BLE001
        return {"error": f"{type(e).__name__}: {e}", "reduced": reduced}
    return {"shape": {"seq_len": cut.seq_len,
                      "global_batch": cut.global_batch},
            "reduced": reduced, "seconds": seconds,
            "max_memory_allocated": peak,
            "meta_peak_bytes": int(meta_peak),
            "meta_over_real": meta_peak / peak if peak else None}


def _materialize(cfg, plan: CellPlan, dev: torch.device,
                 gen: torch.Generator):
    """The cell's arguments as real tensors on ``dev``: seeded weights
    (the family's initialiser), zero caches and states, random inputs."""
    from ..serve.cache import init_cache
    from ..train.step import bf16_cast, init_train_state, model_init
    shape = plan.shape
    B, S = shape.global_batch, shape.seq_len

    def batch(names):
        out = {}
        for k in names:
            if k in ("tokens", "labels"):
                out[k] = torch.randint(0, cfg.vocab_size, (B, S),
                                       generator=gen, device=dev,
                                       dtype=torch.int32)
            else:
                out[k] = torch.randn((B, cfg.n_frontend_tokens,
                                      cfg.d_model), generator=gen,
                                     device=dev)
        return out

    if shape.kind == "train":
        return (init_train_state(gen, cfg, dev),
                batch(plan.abstract_args[1]))
    params = model_init(cfg)(cfg, gen, dev, dtype=torch.float32)
    if shape.kind == "prefill":
        return params, batch(plan.abstract_args[1])
    params = bf16_cast(params)
    token = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen,
                          device=dev, dtype=torch.int32)
    if plan.pqkv is None:
        cache = init_cache(cfg, B, S, device=dev)
    else:
        from ..serve.pqkv import init_pq_cache
        pqc = plan.pqkv
        books = torch.randn((cfg.n_layers, cfg.n_kv_heads, pqc.n_sub,
                             pqc.codebook_size,
                             cfg.head_dim_ // pqc.n_sub), generator=gen,
                            device=dev)
        cache = init_pq_cache(cfg, pqc, B, S, books, device=dev,
                              v_books=books if pqc.quantize_v else None)
    return params, cache, token, plan.abstract_args[3]


def real_step(arch: str, shape: ShapeSpec, extra: Optional[dict] = None,
              device: str = "cuda", seed: int = 0, cfg=None) -> tuple:
    """``(seconds, max_memory_allocated)`` of one step of the cell on
    ``device`` after one warm-up step (cuBLAS's set-up and the
    allocator's growth stay outside the clock), its arguments made there
    first (inside the peak, as the meta pass counts them); the peak is
    ``None`` off the card.  ``cfg`` replaces the arch's config (tests)."""
    from .._device import resolve_device
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    plan = build_cell(arch, shape, extra=extra, cfg=cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if on_card:
        # repro: ignore[RS101] benchmark timing: the clock is read once the card is done
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    args = _materialize(plan.cfg, plan, dev, gen)
    plan.fn(*args)                       # the warm-up step
    if on_card:
        # repro: ignore[RS101] benchmark timing: the clock is read once the card is done
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = plan.fn(*args)
    if on_card:
        # repro: ignore[RS101] benchmark timing: the clock is read once the card is done
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if on_card else None
    del out, args
    if on_card:
        torch.cuda.empty_cache()
    return seconds, peak


def _fmt(rec: dict) -> str:
    mesh = rec.get("mesh", "card")
    if not rec["ok"]:
        return (f"FAIL  {rec['arch']:24s} {rec['shape']:12s} {mesh:6s} "
                f"{rec.get('error', '?')[:90]}")
    r, m = rec["roofline"], rec["memory"]
    line = (f"{'fit ' if rec['fit'] else 'NOFIT'} {rec['arch']:24s} "
            f"{rec['shape']:12s} {mesh:6s} "
            f"peak={m['peak_bytes'] / 2 ** 30:8.2f}GiB "
            f"C={r['compute_s'] * 1e3:10.2f}ms "
            f"(bf16 {r['flops_bf16']:.3g} f32 {r['flops_f32']:.3g}) "
            f"M={r['memory_s'] * 1e3:10.2f}ms "
            f"(eager {r['memory_eager_s'] * 1e3:.2f}ms) "
            f"K={r['collective_s'] * 1e3:.2f}ms bound={r['bound']:10s} "
            f"frac={r['roofline_frac']:.3f} [{rec['wall_s']:.1f}s]")
    run = rec.get("run")
    if run and "seconds" in run:
        line += (f"  run: {run['seconds']:.3f}s max_alloc="
                 f"{run['max_memory_allocated'] / 2 ** 30:.2f}GiB meta="
                 f"{run['meta_peak_bytes'] / 2 ** 30:.2f}GiB")
    elif run:
        line += f"  run: {run.get('skipped') or run.get('error')}"
    return line


def _count_one(job) -> None:
    torch.set_num_threads(1)
    arch, shape_name, out, force, extra, tag, mesh_name = job
    run_cell(arch, shape_name, out, force=force, extra=extra, tag=tag,
             mesh_name=mesh_name)


def _count_parallel(cells, args, extra) -> None:
    """Write the meta records of ``cells`` from ``args.jobs`` spawned
    processes, the costliest kinds first (prefill, then train); real
    steps, if asked for, follow in this process."""
    import concurrent.futures
    import multiprocessing
    order = {"prefill": 0, "train": 1, "decode": 2}
    jobs = sorted(((a, s, args.out, args.force, extra, args.tag, m)
                   for a, s, m in cells),
                  key=lambda j: order[SHAPES[j[1]].kind])
    with concurrent.futures.ProcessPoolExecutor(
            args.jobs, mp_context=multiprocessing.get_context("spawn")) as ex:
        list(ex.map(_count_one, jobs))
    args.force = False          # the records are fresh: only read them


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--mesh", default="card",
                    choices=("card", "single", "multi", "both"),
                    help="card: one card; single: the 16x16 mesh (256 "
                         "devices); multi: 2x16x16 (512); both: single "
                         "and multi")
    ap.add_argument("--all", action="store_true",
                    help="every applicable (arch x shape) cell")
    ap.add_argument("--out", default=DRYRUN_DIR)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="", help="variant tag")
    ap.add_argument("--extra", default="",
                    help="JSON overrides, e.g. "
                         "'{\"microbatch_rows\": 2, \"loss_chunk\": 512}'; "
                         "\"pqkv\": {...} builds a PQ-compressed decode cell")
    ap.add_argument("--run", action="store_true",
                    help="also one real step on the card where the meta "
                         "peak leaves 10%% free")
    ap.add_argument("--device", default="cuda",
                    help="the card for --run (cuda)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="processes counting cells on meta tensors")
    args = ap.parse_args(argv)
    meshes = ("single", "multi") if args.mesh == "both" else (args.mesh,)
    if args.run and args.mesh != "card":
        ap.error("--run takes one real step on the card: --mesh card")
    cells = []
    if args.all:
        for arch, shape, ok, why in all_cells():
            if not ok:
                print(f"skip  {arch:24s} {shape.name:12s} ({why})")
                continue
            cells += [(arch, shape.name, m) for m in meshes]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells += [(args.arch, args.shape, m) for m in meshes]
    extra = json.loads(args.extra) if args.extra else None
    if extra and "pqkv" in extra:
        from ..serve.pqkv import PQKVConfig
        extra["pqkv"] = PQKVConfig(**extra["pqkv"])
    if args.jobs > 1:
        _count_parallel(cells, args, extra)
    n_fail = 0
    for arch, shape_name, mesh_name in cells:
        rec = run_cell(arch, shape_name, args.out, force=args.force,
                       extra=extra, tag=args.tag, run=args.run,
                       device=args.device, mesh_name=mesh_name)
        print(_fmt(rec), flush=True)
        n_fail += 0 if rec["ok"] else 1
    print(f"\ndone: {len(cells) - n_fail} ok, {n_fail} failed")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
