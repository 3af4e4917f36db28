"""Multi-process worker for the port's parallel tests, one OS process a
rank of a gloo group over localhost; the counterpart of
``tests/mp_worker.py`` for ``ternary_spgemm_tpu_torch``. It imports no
JAX: the test modules compute the JAX side in their own process, write the
inputs to a directory, and :func:`spawn` starts the group, which runs every
case of one suite and writes its results there (rank 0; each rank its
checkpoint shard file).

Not a pytest module (no ``test_`` prefix). Run as a script:
``python torch_mp_worker.py <suite> <rank> <world> <port> <dir>``; the
suites are ``parallel``, ``ffn``, ``pipeline`` and ``train``.
"""

import json
import os
import socket
import subprocess
import sys
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(suite: str, world: int, tmp, timeout: int = 400):
    """Run ``suite`` in a gloo group of ``world`` processes over
    ``tmp`` (which holds the suite's inputs) and return ``(arrays,
    record)``: the arrays rank 0 wrote and its JSON record (per case its
    scalars, or the error it raised)."""
    import numpy as np
    import pytest

    try:
        port = free_port()
    except OSError as e:  # sockets forbidden: nothing to run on
        pytest.skip(f"cannot bind a localhost socket: {e}")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, suite, str(r), str(world), str(port),
         str(tmp)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env) for r in range(world)]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        outs = [p.communicate()[0] for p in procs]
        pytest.fail(f"{suite} ranks timed out:\n" + "\n----\n".join(
            o[-3000:] for o in outs))
    if any(p.returncode for p in procs):
        pytest.fail(f"{suite} ranks failed:\n" + "\n----\n".join(
            o[-3000:] for o in outs))
    with np.load(os.path.join(tmp, f"out_{suite}.npz")) as data:
        arrays = {k: data[k] for k in data.files}
    with open(os.path.join(tmp, f"out_{suite}.json")) as f:
        return arrays, json.load(f)


class Results:
    """What rank 0 writes: arrays by name and a JSON record by case."""

    def __init__(self):
        self.arrays, self.record = {}, {}

    def put(self, name, t):
        import torch
        from torch.distributed.tensor import DTensor

        if isinstance(t, DTensor):
            t = t.full_tensor()
        if isinstance(t, torch.Tensor):
            t = t.detach().to("cpu", copy=True)
            if t.dtype == torch.bfloat16:
                t = t.float()
            t = t.numpy()
        self.arrays[name] = t

    def note(self, case, **kv):
        self.record.setdefault(case, {}).update(kv)

    def run(self, case, fn):
        """Run ``fn`` (the same on every rank); an exception is recorded,
        not raised (a ValueError / TypeError of an error case comes before
        any collective, on every rank alike)."""
        try:
            fn()
        except Exception as e:  # noqa: BLE001 - recorded for the test
            self.note(case, raised=type(e).__name__, message=str(e),
                      trace=traceback.format_exc()[-2000:])

    def write(self, tmp, suite):
        import numpy as np

        np.savez(os.path.join(tmp, f"out_{suite}.npz"), **self.arrays)
        with open(os.path.join(tmp, f"out_{suite}.json"), "w") as f:
            json.dump(self.record, f)


def full_state(model):
    """Every parameter whole (``full_tensor()``: a collective, every rank
    calls it), keyed by ``state_dict()`` path."""
    from torch.distributed.tensor import DTensor

    return {n: (p.full_tensor() if isinstance(p, DTensor) else p).detach()
            for n, p in model.named_parameters()}


def load_inputs(tmp, suite):
    import numpy as np

    path = os.path.join(tmp, f"in_{suite}.npz")
    if not os.path.exists(path):
        return {}
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def unflat(inputs, prefix):
    """The nested dict / list tree saved under ``prefix/`` (keys joined by
    '/', all-digit levels lists)."""
    from ternary_spgemm_tpu_torch.models.convert import _unflat

    flat = {k[len(prefix) + 1:].replace("/", "."): v
            for k, v in inputs.items() if k.startswith(prefix + "/")}
    return _unflat(flat)


# ---------------------------------------------------------------------------
# suites
# ---------------------------------------------------------------------------


def suite_parallel(res, inputs, tmp):
    """The sharded SpMM schemes (tests/test_parallel.py's cases)."""
    import numpy as np
    import torch

    from ternary_spgemm_tpu_torch.formats import (
        TCSC, BlockedEllTCSC, BlockPackedTernary, DenseTernary,
        PackedTernary53, TiledBitplane, TiledBlockPacked, TiledDenseTernary,
        generate_alpha, generate_bias, generate_ternary, generate_x)
    from ternary_spgemm_tpu_torch.parallel import (
        column_leaf_specs, column_sharded_spgemm, container_from_local_shard,
        make_mesh, overlapped_gather_spgemm, row_sharded_spgemm,
        shard_container)

    M, K, N, S = 16, 128, 512, 4
    W = generate_ternary(K, N, S, seed=11)
    X = torch.from_numpy(generate_x(M, K, seed=12))
    b = torch.from_numpy(generate_bias(N))
    alpha = torch.from_numpy(generate_alpha(N))
    mesh = {d: make_mesh({"model": d}, device_type="cpu") for d in (2, 4)}
    m4 = mesh[4]

    def column(cls):
        fmt = cls.from_dense(W, **({"tile_n": 128} if cls is TiledBitplane
                                   else {}))
        res.put(f"column/{cls.__name__}", column_sharded_spgemm(
            X, fmt, b, mesh=m4, axis="model"))
        res.put(f"column/{cls.__name__}/prelu", column_sharded_spgemm(
            X, fmt, b, alpha, mesh=m4, axis="model"))

    for cls in (DenseTernary, PackedTernary53, BlockedEllTCSC, TiledBitplane):
        res.run(f"column/{cls.__name__}", lambda: column(cls))

    def placed():
        fmt = shard_container(DenseTernary.from_dense(W), m4,
                              column_leaf_specs(DenseTernary, "model"))
        res.note("placed", leaf_placements=str(fmt.dense.placements))
        res.put("placed", column_sharded_spgemm(X, fmt, b, mesh=m4,
                                                axis="model"))

    res.run("placed", placed)

    def two_d():
        m22 = make_mesh({"data": 2, "model": 2}, device_type="cpu")
        y = column_sharded_spgemm(X, PackedTernary53.from_dense(W), b,
                                  mesh=m22, axis="model", batch_axis="data")
        res.note("2d", placements=str(y.placements))
        res.put("2d", y)

    res.run("2d", two_d)

    def row(scatter):
        fmt = DenseTernary.from_dense(W)
        y = row_sharded_spgemm(X, fmt, b, mesh=m4, axis="model",
                               scatter_output=scatter)
        res.note(f"row/{scatter}", placements=str(y.placements))
        res.put(f"row/{scatter}", y)
        res.put(f"row/{scatter}/prelu", row_sharded_spgemm(
            X, fmt, b, alpha, mesh=m4, axis="model", scatter_output=scatter))

    for scatter in (False, True):
        res.run(f"row/{scatter}", lambda: row(scatter))

    rows = {
        "row_blocked_ell": lambda: BlockedEllTCSC.from_dense(W, block_k=32),
        "row_blockpacked": lambda: BlockPackedTernary.from_dense(
            W, factor=4, tile_kq=8),
        "row_tiled_dense": lambda: TiledDenseTernary.from_dense(
            W, tile_k=32, tile_n=128),
        "row_tiled_blockpacked": lambda: TiledBlockPacked.from_dense(
            W, factor=4, tile_kq=8, tile_n=128),
        "row_tiled_bitplane": lambda: TiledBitplane.from_dense(W, tkb=4),
    }
    for name, build in rows.items():
        res.run(name, lambda: res.put(name, row_sharded_spgemm(
            X, build(), b, mesh=m4, axis="model")))
    res.run("column_tiled_dense", lambda: res.put(
        "column_tiled_dense", column_sharded_spgemm(
            X, TiledDenseTernary.from_dense(W, tile_k=32, tile_n=128), b,
            mesh=m4, axis="model")))

    for cls in (DenseTernary, PackedTernary53):
        def ring(cls=cls):
            fmt = cls.from_dense(W)
            y = overlapped_gather_spgemm(X, fmt, b, mesh=m4, axis="model")
            res.note(f"ring/{cls.__name__}", placements=str(y.placements))
            res.put(f"ring/{cls.__name__}", y)
            res.put(f"ring/{cls.__name__}/prelu", overlapped_gather_spgemm(
                X, fmt, b, alpha, mesh=m4, axis="model"))
        res.run(f"ring/{cls.__name__}", ring)

    # container_from_local_shard: each rank packs only its own columns/rows
    def from_local():
        d, r = 4, m4.get_local_rank("model")
        cols = slice(r * N // d, (r + 1) * N // d)
        fmt = container_from_local_shard(
            PackedTernary53.from_dense(W[:, cols]), m4, "model", dim="N",
            K=K, N=N)
        res.put("local_shard/column", column_sharded_spgemm(
            X, fmt, b, mesh=m4, axis="model"))
        res.put("local_shard/ring", overlapped_gather_spgemm(
            X, fmt, b, mesh=m4, axis="model"))
        rws = slice(r * K // d, (r + 1) * K // d)
        fmt_r = container_from_local_shard(
            DenseTernary.from_dense(W[rws]), m4, "model", dim="K", K=K, N=N)
        res.put("local_shard/row", row_sharded_spgemm(
            X, fmt_r, b, mesh=m4, axis="model", scatter_output=True))

    res.run("local_shard", from_local)

    # the error cases: JAX's exceptions and texts
    errors = {
        "err/global_packed_row": lambda: row_sharded_spgemm(
            X, PackedTernary53.from_dense(W), b, mesh=m4, axis="model"),
        "err/tiled_column": lambda: column_sharded_spgemm(
            X, TiledDenseTernary.from_dense(W[:, :N - 128], tile_k=32,
                                            tile_n=256),
            b[:N - 128], mesh=mesh[2], axis="model"),
        "err/blockpacked_row": lambda: row_sharded_spgemm(
            X[:, :112], BlockPackedTernary.from_dense(W[:112], factor=4,
                                                      tile_kq=16),
            b, mesh=mesh[2], axis="model"),
        "err/blockpacked_block_split": lambda: row_sharded_spgemm(
            X, BlockPackedTernary.from_dense(W, factor=4, tile_kq=16), b,
            mesh=m4, axis="model"),
        "err/blocked_ell_column": lambda: column_sharded_spgemm(
            X, BlockedEllTCSC.from_dense(W[:, :N - 128], tile_n=256),
            b[:N - 128], mesh=mesh[2], axis="model"),
        "err/blocked_ell_row": lambda: row_sharded_spgemm(
            X[:, :112], BlockedEllTCSC.from_dense(W[:112], block_k=64), b,
            mesh=mesh[2], axis="model"),
        "err/unshardable": lambda: column_sharded_spgemm(
            X, TCSC.from_dense(W), b, mesh=m4, axis="model"),
    }
    for name, fn in errors.items():
        res.run(name, fn)
    res.put("want", X @ torch.from_numpy(W.astype(np.float32)) + b)


def suite_ffn(res, inputs, tmp):
    """The tensor-parallel fused SwiGLU (tests/test_parallel_ffn.py)."""
    import torch

    from ternary_spgemm_tpu_torch.formats import TiledBitplane
    from ternary_spgemm_tpu_torch.ops.fused_ffn import (
        fused_bitplane_swiglu, unfused_reference_swiglu)
    from ternary_spgemm_tpu_torch.parallel import (
        make_mesh, tensor_parallel_fused_swiglu)

    gam = {k: float(inputs[f"gamma/{k}"])
           for k in ("gamma_gate", "gamma_up", "gamma_down")}
    meshes = {d: make_mesh({"tp": d}, device_type="cpu") for d in (1, 2, 4)}

    def problem(name, tile_n, tkb_down=16):
        t = lambda k: torch.from_numpy(inputs[f"{name}/{k}"])
        fmts = (TiledBitplane.from_dense(t("Wg"), tile_n=tile_n),
                TiledBitplane.from_dense(t("Wu"), tile_n=tile_n),
                TiledBitplane.from_dense(t("Wd"), tkb=tkb_down))
        return (t("Wg"), t("Wu"), t("Wd")), fmts, t("xq"), t("sx")

    def per_shard(Ws, xq, sx, d, tile_n):
        """The sum of per-shard unfused blocks (the port's plain kernel)."""
        Wg, Wu, Wd = Ws
        w = Wg.shape[1] // d
        y = 0
        for s in range(d):
            cols = slice(s * w, (s + 1) * w)
            y = y + unfused_reference_swiglu(
                xq, sx, TiledBitplane.from_dense(Wg[:, cols], tile_n=tile_n),
                TiledBitplane.from_dense(Wu[:, cols], tile_n=tile_n),
                TiledBitplane.from_dense(Wd[cols], tkb=16),
                kernel="CudaTiledBitplane_i8", **gam)
        return y

    for d, tile_n in ((1, 256), (2, 256), (4, 128)):
        def tp(d=d, tile_n=tile_n):
            Ws, fmts, xq, sx = problem(f"p{tile_n}", tile_n)
            y = tensor_parallel_fused_swiglu(xq, sx, *fmts, mesh=meshes[d],
                                             axis="tp", **gam)
            res.put(f"tp/{d}/{tile_n}", y)
            res.put(f"tp/{d}/{tile_n}/ref", per_shard(Ws, xq, sx, d, tile_n))
        res.run(f"tp/{d}/{tile_n}", tp)

    def p1():
        _, fmts, xq, sx = problem("p256", 256)
        res.put("p1", tensor_parallel_fused_swiglu(
            xq, sx, *fmts, mesh=meshes[1], axis="tp", **gam))
        res.put("p1/single", fused_bitplane_swiglu(xq, sx, *fmts, **gam))

    res.run("p1", p1)

    def scatter():
        Ws, fmts, xq, sx = problem("p256", 256)
        y = tensor_parallel_fused_swiglu(xq, sx, *fmts, mesh=meshes[2],
                                         axis="tp", scatter_output=True,
                                         **gam)
        res.note("scatter", placements=str(y.placements),
                 local=list(y.to_local().shape))
        res.put("scatter", y)

    res.run("scatter", scatter)

    def subtile():
        Ws, fmts, xq, sx = problem("sub", 128)
        y = tensor_parallel_fused_swiglu(xq, sx, *fmts, mesh=meshes[2],
                                         axis="tp", **gam)
        res.put("subtile", y)
        res.put("subtile/ref", per_shard(Ws, xq, sx, 2, 128))

    res.run("subtile", subtile)

    Ws, fmts, xq, sx = problem("p128", 128)
    Ws2, fmts2, _, _ = problem("p256", 256)
    wide = torch.from_numpy(inputs["wide_down"])
    errors = {
        "err/kblock": lambda: tensor_parallel_fused_swiglu(
            xq, sx, fmts[0], fmts[1], TiledBitplane.from_dense(Ws[2]),
            mesh=meshes[4], axis="tp", **gam),
        "err/tiles": lambda: tensor_parallel_fused_swiglu(
            xq, sx, *fmts2, mesh=meshes[4], axis="tp", **gam),
        "err/down_k": lambda: tensor_parallel_fused_swiglu(
            xq, sx, fmts[0], fmts[1],
            TiledBitplane.from_dense(Ws[2][:256], tkb=16),
            mesh=meshes[4], axis="tp", **gam),
        "err/scatter_n2": lambda: tensor_parallel_fused_swiglu(
            xq, sx, fmts[0], fmts[1], TiledBitplane.from_dense(wide, tkb=16),
            mesh=meshes[4], axis="tp", scatter_output=True, **gam),
    }
    for name, fn in errors.items():
        res.run(name, fn)


def _lm(inputs, prefix, cfg_json):
    from ternary_spgemm_tpu_torch.models import (
        BitTransformerConfig, qat_lm_from_jax_params)

    cfg = BitTransformerConfig(**json.loads(str(inputs[cfg_json])))
    return qat_lm_from_jax_params(cfg, unflat(inputs, prefix), device="cpu")


def suite_pipeline(res, inputs, tmp):
    """The GPipe schedule (tests/test_pipeline.py)."""
    import torch
    import torch.distributed as dist

    from ternary_spgemm_tpu_torch.parallel import (
        make_mesh, pipeline_apply, pipeline_lm_apply, stack_stages)
    from ternary_spgemm_tpu_torch.parallel.pipeline import lm_stage_params

    meshes = {p: make_mesh({"pipe": p}, device_type="cpu") for p in (2, 4)}
    toks = lambda name: torch.from_numpy(inputs[f"{name}/toks"]).long()

    for stages, n_micro in ((4, 2), (2, 4), (4, 8)):
        def lm(stages=stages, n_micro=n_micro):
            model = _lm(inputs, "lm/params", "lm/cfg")
            with torch.no_grad():
                res.put(f"lm/{stages}/{n_micro}", pipeline_lm_apply(
                    model, toks("lm"), meshes[stages], n_micro=n_micro))
        res.run(f"lm/{stages}/{n_micro}", lm)

    def generic():
        mats = torch.from_numpy(inputs["generic/mats"])
        stacked = stack_stages([{"A": m} for m in mats])
        x = torch.from_numpy(inputs["generic/x"])
        res.put("generic", pipeline_apply(lambda p, h: h @ p["A"], stacked,
                                          x, meshes[4], n_micro=3))
        # an inf in the last microbatch, which later stages read as the
        # branch they drop
        x = x.clone()
        x[4, 0] = torch.inf
        res.put("generic_inf", pipeline_apply(lambda p, h: h @ p["A"],
                                              stacked, x, meshes[4],
                                              n_micro=3))

    res.run("generic", generic)

    def grads():
        model = _lm(inputs, "grad/params", "lm/cfg")
        mesh = meshes[2]
        logits = pipeline_lm_apply(model, toks("grad"), mesh, n_micro=4)
        torch.mean(logits ** 2).backward()
        for n, p in model.named_parameters():
            g = p.grad.clone()
            if n.startswith("blocks."):  # each stage holds its own blocks'
                dist.all_reduce(g, group=mesh.get_group("pipe"))
            res.put(f"grad/{n}", g)

    res.run("grad", grads)

    def bad_split():
        model = _lm(inputs, "lm/params", "lm/cfg")
        res.run("err/micro", lambda: pipeline_lm_apply(
            model, toks("lm")[:6], meshes[4], n_micro=4))
        res.run("err/stages", lambda: lm_stage_params(model, 3))

    res.run("bad_split", bad_split)

    for name in ("moe", "bf16"):
        def variant(name=name):
            model = _lm(inputs, f"{name}/params", f"{name}/cfg")
            with torch.no_grad():
                res.put(name, pipeline_lm_apply(model, toks(name),
                                                meshes[2], n_micro=2))
        res.run(name, variant)


def suite_train(res, inputs, tmp):
    """The sharded train steps and checkpoints (tests/test_sequence_
    parallel.py, test_train_features.py:90-150, test_models.py:216,
    test_transformer.py:65, the checkpoint half of mp_worker.py)."""
    import torch
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.experimental import implicit_replication

    from ternary_spgemm_tpu_torch.checkpoint import (
        restore_sharded_pytree, save_sharded_pytree)
    from ternary_spgemm_tpu_torch.models import (
        make_sharded_lm_train_step, make_sharded_train_step,
        mlp_from_jax_params)
    from ternary_spgemm_tpu_torch.models.convert import _unflat
    from ternary_spgemm_tpu_torch.parallel import make_mesh, placements

    m24 = make_mesh({"data": 2, "model": 4}, device_type="cpu")
    m42 = make_mesh({"data": 4, "model": 2}, device_type="cpu")
    toks = lambda name: torch.from_numpy(inputs[f"{name}/toks"]).long()

    def mlp():
        model = mlp_from_jax_params(unflat(inputs, "mlp/params")["layers"],
                                    device="cpu")
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)
        step, place = make_sharded_train_step(model, opt, m24)
        x, y = place(torch.ones(8, 16), torch.zeros(8, 16))
        before = model.layers[0].w.placements
        res.note("mlp", loss=float(step(x, y)),
                 kept=model.layers[0].w.placements == before,
                 placements=str(before))

    res.run("mlp", mlp)

    def lm_run(name, prefix, cfg, mesh, opt_fn, steps, **kw):
        model = _lm(inputs, prefix, cfg)
        opt = opt_fn(model.parameters())
        step, place = make_sharded_lm_train_step(model, opt, mesh, **kw)
        t = place(toks(prefix.split("/")[0]))
        losses = [float(step(t)) for _ in range(steps)]
        res.note(name, losses=losses)
        return model, opt, step, t

    sgd = lambda ps: torch.optim.SGD(ps, lr=1e-2)
    adam = lambda ps: torch.optim.Adam(ps, lr=1e-2, foreach=False)

    def lm_step():
        lm_run("lm_step", "tlm/params", "tlm/cfg", m24, sgd, 1)

    res.run("lm_step", lm_step)

    def ckpt():
        model = _lm(inputs, "sp/params", "sp/cfg")
        opt = sgd(model.parameters())
        _, place = make_sharded_lm_train_step(model, opt, m24)
        place(toks("sp"))
        tree = _unflat(dict(model.named_parameters()))
        path = os.path.join(tmp, "port_ckpt")
        save_sharded_pytree(path, tree)
        torch.distributed.barrier()
        back = restore_sharded_pytree(path, tree)
        from ternary_spgemm_tpu_torch.checkpoint import _leaves

        same = all(isinstance(b, DTensor) and b.placements == a.placements
                   and torch.equal(a.to_local(), b.to_local())
                   for a, b in zip(_leaves(tree), _leaves(back)))
        res.note("ckpt", restored_equal=bool(same))
        bad = dict(tree, embed=tree["embed"][:, :8])
        res.run("err/ckpt_shape", lambda: restore_sharded_pytree(path, bad))
        other = {k: (v.redistribute(m24, placements(m24, ("data",)))
                     if k == "norm_out" else v) for k, v in tree.items()}
        res.run("err/ckpt_index", lambda: restore_sharded_pytree(path, other))

    res.run("ckpt", ckpt)

    for sp in (False, True):
        def sp_run(sp=sp):
            model, *_ = lm_run(f"sp/{sp}", "sp/params", "sp/cfg", m24, sgd,
                               2, sequence_parallel=sp)
            for n, p in full_state(model).items():
                res.put(f"sp/{sp}/{n}", p)
        res.run(f"sp/{sp}", sp_run)

    for sp in (False, True):
        def moe_sgd(sp=sp):
            model, *_ = lm_run(f"moe_sgd/{sp}", "moe/params", "moe/cfg", m24,
                               sgd, 2, sequence_parallel=sp)
            for n, p in full_state(model).items():
                res.put(f"moe_sgd/{sp}/{n}", p)
        res.run(f"moe_sgd/{sp}", moe_sgd)

    def counts():
        for sp in (False, True):
            model = _lm(inputs, "sp/params", "sp/cfg")
            step, place = make_sharded_lm_train_step(
                model, sgd(model.parameters()), m24, sequence_parallel=sp)
            t = place(toks("sp"))
            step(t)
            with CommDebugMode() as comm:
                step(t)
            c = {str(k).split(".")[-1]: v
                 for k, v in comm.get_comm_counts().items()}
            res.note("counts", **{str(sp): c})

    res.run("counts", counts)

    def sp_moe():
        model, opt, step, t = lm_run("sp_moe", "moe/params", "moe/cfg", m24,
                                     sgd, 0, sequence_parallel=True)
        act = placements(m24, ("data", "model", None))
        con = lambda z: z.redistribute(m24, act)
        with torch.no_grad(), implicit_replication():
            res.put("sp_moe", model(t, constrain=con))
        res.note("sp_moe", loss=float(step(t)))

    res.run("sp_moe", sp_moe)

    res.run("gqa", lambda: lm_run("gqa", "gqa/params", "gqa/cfg", m24, sgd,
                                  1, sequence_parallel=True))

    def zero1():
        model, opt, step, t = lm_run("zero1", "sp/params", "sp/cfg", m42,
                                     adam, 0, zero1=True)
        mu = lambda: opt.state[model.blocks[0].wq.w]["exp_avg"].placements
        res.note("zero1", placed=str(mu()),
                 want=str(tuple(placements(m42, ("data", "model")))),
                 losses=[float(step(t)) for _ in range(3)], stepped=str(mu()))

    res.run("zero1", zero1)

    def zero1_moe():
        model, opt, step, t = lm_run("zero1_moe", "moe/params", "moe/cfg",
                                     m24, adam, 1, zero1=True,
                                     sequence_parallel=True)
        wg = opt.state[model.blocks[0].moe.w_gate]["exp_avg"]
        res.note("zero1_moe", placements=str(wg.placements),
                 mesh=list(m24.mesh_dim_names))

    res.run("zero1_moe", zero1_moe)


SUITES = {"parallel": suite_parallel, "ffn": suite_ffn,
          "pipeline": suite_pipeline, "train": suite_train}


def main(argv):
    suite, rank, world, port, tmp = (argv[0], int(argv[1]), int(argv[2]),
                                     argv[3], argv[4])
    sys.path.insert(0, ROOT)
    import torch

    torch.set_num_threads(1)
    from ternary_spgemm_tpu_torch.parallel import init_distributed

    init_distributed(rank, world, f"tcp://127.0.0.1:{port}", "cpu")
    res = Results()
    SUITES[suite](res, load_inputs(tmp, suite), tmp)
    import torch.distributed as dist

    # what each rank recorded as raised, for a group that fails later
    print(f"rank {rank} raised in:", {k: v["message"][:200] for k, v in
                                      res.record.items() if "raised" in v},
          flush=True)

    dist.barrier()
    if rank == 0:
        res.write(tmp, suite)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
