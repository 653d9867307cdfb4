"""The compressed cross-pod gradient exchange against repro's.

The oracle is ``jax.vmap(pod_allreduce_compressed, axis_name="pod")``,
which runs the JAX package's collective form on one CPU. The port's
``pod_allreduce_compressed`` runs on a 2-process ``gloo`` group, and the
compressed train step's global view (``steps.pod_exchange``) on 2 and 3
pods. The int8 payloads must be equal, the averages and the new residuals
within 2 ulp. Then the port's compressed step (mamba2-370m at
``.scaled()``, 2 pods) against the JAX package's per-pod
``value_and_grad`` + ``quantize_shard`` + mean, written out as
``repro/runtime/steps.py`` computes it.
"""
import os
import socket
import subprocess
import sys
import textwrap
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_lm_oracle as oracle
from repro.optim import adamw as jadamw
from repro.optim.grad_compress import pod_allreduce_compressed as jallreduce
from repro.optim.grad_compress import quantize_shard as jquantize
from repro_torch.core.tree import leaf_paths
from repro_torch.models.convert import tree_to_numpy
from repro_torch.optim import quantize_shard
from repro_torch.runtime.steps import make_train_state, make_train_step, pod_exchange

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ULP = 2
SHAPES = {"a": (33, 17), "b": (100,), "c": (4, 5, 6)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ulps(a, b, ref) -> float:
    """max |a - b| in float32 units in the last place of ``ref``, the
    magnitude of the terms that ``a`` adds: where those terms cancel, an
    ulp of the result is no measure of the arithmetic (XLA contracts
    ``t - q * scale`` and the pods' products into FMAs, torch rounds each)."""
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return float((d / np.spacing(np.abs(np.asarray(ref, np.float32)))).max())


def pod_inputs(npods: int, seed: int = 0):
    """Per-pod gradients and residuals (leading pod axis), float32."""
    r = np.random.default_rng(seed)
    g = {k: (r.standard_normal((npods,) + s) * r.uniform(0.01, 3.0, (npods,) + (1,) * len(s))).astype(np.float32)
         for k, s in SHAPES.items()}
    res = {k: (r.standard_normal((npods,) + s) * 1e-3).astype(np.float32) for k, s in SHAPES.items()}
    return g, res


def oracle_exchange(g, res):
    """The JAX collective under vmap: per-pod averages and residuals, the
    int8 payloads and scales each pod sends, and the magnitudes the
    averages and residuals are measured against (mean |q * scale| over the
    pods, |g + r|)."""
    avg, new_r = jax.vmap(lambda a, b: jallreduce(a, b, "pod"), axis_name="pod")(
        jax.tree.map(jnp.asarray, g), jax.tree.map(jnp.asarray, res))
    q, s, ref_avg, ref_res = {}, {}, {}, {}
    for k in g:
        t = jnp.asarray(g[k]) + jnp.asarray(res[k])
        qk, sk = jax.vmap(jquantize)(t)
        q[k], s[k] = np.asarray(qk), np.asarray(sk)
        terms = np.abs(q[k].astype(np.float32) * s[k].reshape((-1,) + (1,) * (q[k].ndim - 1)))
        ref_avg[k], ref_res[k] = terms.mean(0), np.abs(np.asarray(t))
    return jax.tree.map(np.asarray, avg), jax.tree.map(np.asarray, new_r), q, s, ref_avg, ref_res


WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.optim import pod_allreduce_compressed, quantize_shard

    rank, port, src, dst = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=2)
    try:
        z = np.load(src)
        keys = sorted({k.split(":", 1)[1] for k in z.files})
        g = {k: torch.from_numpy(z["g:" + k][rank]) for k in keys}
        r = {k: torch.from_numpy(z["r:" + k][rank]) for k in keys}
        avg, new_r = pod_allreduce_compressed(g, r)
        out = {}
        for k in keys:
            q, s = quantize_shard(g[k] + r[k])
            out["avg:" + k], out["res:" + k], out["q:" + k] = avg[k].numpy(), new_r[k].numpy(), q.numpy()
            out["s:" + k] = s.numpy()
        np.savez(dst, **out)
    finally:
        dist.destroy_process_group()
""")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_pod_allreduce_on_a_two_process_gloo_group_matches_the_vmap_oracle(tmp_path):
    g, res = pod_inputs(2)
    src = tmp_path / "in.npz"
    np.savez(src, **{f"g:{k}": v for k, v in g.items()}, **{f"r:{k}": v for k, v in res.items()})
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    port = str(free_port())
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(rank), port, str(src), str(tmp_path / f"out{rank}.npz")],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE) for rank in range(2)]
    try:
        outs = [p.communicate(timeout=60) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err.decode()[-3000:]
    avg, new_r, q, s, ref_avg, ref_res = oracle_exchange(g, res)
    for rank in range(2):
        z = np.load(tmp_path / f"out{rank}.npz")
        for k in SHAPES:
            assert np.array_equal(z["q:" + k], q[k][rank]) and z["q:" + k].dtype == np.int8
            assert z["s:" + k] == s[k][rank]
            assert ulps(z["avg:" + k], avg[k][rank], ref_avg[k]) <= ULP, (rank, k)
            assert ulps(z["res:" + k], new_r[k][rank], ref_res[k][rank]) <= ULP, (rank, k)
        assert all(np.array_equal(z["avg:" + k], np.load(tmp_path / "out0.npz")["avg:" + k]) for k in SHAPES)


@pytest.mark.parametrize("npods", [2, 3])
def test_the_compressed_steps_global_view_matches_the_vmap_oracle(npods):
    g, res = pod_inputs(npods, seed=npods)
    avg, new_r, q, s, ref_avg, ref_res = oracle_exchange(g, res)
    for k in SHAPES:
        a, nr, tq, ts = pod_exchange(torch.from_numpy(g[k]), torch.from_numpy(res[k]))
        assert torch.equal(tq, torch.from_numpy(q[k])) and tq.dtype == torch.int8
        assert np.array_equal(ts.reshape(-1).numpy(), s[k])
        assert ulps(nr.numpy(), new_r[k], ref_res[k]) <= ULP
        for p in range(npods):
            assert ulps(a.numpy(), avg[k][p], ref_avg[k]) <= ULP, (k, p)


def test_quantize_shard_matches_jax():
    g, res = pod_inputs(1, seed=7)
    for k in SHAPES:
        t = g[k][0] + res[k][0]
        jq, js = jquantize(jnp.asarray(t))
        tq, ts = quantize_shard(torch.from_numpy(t))
        assert np.array_equal(np.asarray(jq), tq.numpy()) and float(js) == float(ts)


def test_compressed_step_on_two_pods_matches_the_jax_per_pod_exchange():
    jcfg, tcfg = oracle.train_configs("mamba2-370m")
    mesh = types.SimpleNamespace(shape={"pod": 2, "data": 1, "model": 1})
    state = make_train_state(tcfg, torch.Generator().manual_seed(1), npods=2, device="cpu")
    params = jax.tree.map(jnp.asarray, tree_to_numpy(state.params))
    r = np.random.default_rng(3)
    toks = r.integers(0, tcfg.vocab, (4, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    # the JAX package's compressed step, written out as repro/runtime/steps.py computes it
    grad = jax.jit(jax.value_and_grad(oracle.jloss_fn), static_argnums=1).lower(
        params, jcfg, {k: jnp.asarray(v[:2]) for k, v in batch.items()}).compile({"xla_allow_excess_precision": False})
    losses, per_pod = [], []
    for i in range(2):
        loss, gr = grad(params, {k: jnp.asarray(v[2 * i: 2 * i + 2]) for k, v in batch.items()})
        losses.append(loss)
        per_pod.append(gr)
    gp = jax.tree.map(lambda *a: jnp.stack(a), *per_pod)

    def exchange(g):
        t = g.astype(jnp.float32)  # zero residuals at the first step
        scale = jnp.maximum(jnp.max(jnp.abs(t), axis=tuple(range(1, t.ndim)), keepdims=True), 1e-30) / 127.0
        q = jnp.clip(jnp.rint(t / scale), -127, 127).astype(jnp.int8)
        return jnp.mean(q.astype(jnp.float32) * scale, axis=0), t - q.astype(jnp.float32) * scale

    pairs = jax.tree.map(exchange, gp)
    avg = jax.tree.map(lambda p: p[0], pairs, is_leaf=lambda x: isinstance(x, tuple))
    jres = jax.tree.map(lambda p: p[1], pairs, is_leaf=lambda x: isinstance(x, tuple))
    clipped, jnorm = jadamw.clip_by_global_norm(avg, 1.0)
    jparams, jopt = jadamw.adamw_update(params, clipped, jadamw.init_opt(params), 1e-3)

    step = make_train_step(tcfg, mesh, lr=1e-3, compress_pods=True)
    new, metrics = step(state, batch)
    limit_loss, limit_grad = oracle.GRAD_LIMITS[tcfg.family]
    assert abs(float(metrics["loss"]) - float(jnp.mean(jnp.stack(losses)))) < limit_loss
    assert abs(float(metrics["grad_norm"]) - float(jnorm)) < limit_grad * float(jnorm)
    names = [n for n, _ in leaf_paths(new.params)]
    # the averaged, clipped gradient is (1 - b1) * m after the first step
    m_err = oracle.grad_errors(zip(jax.tree.map(np.asarray, jax.tree.leaves(jopt.m)), [x.numpy() for _, x in leaf_paths(new.opt.m)]))
    assert max(m_err) < 2 * limit_grad, names[int(np.argmax(m_err))]
    r_err = oracle.grad_errors(zip(jax.tree.map(np.asarray, jax.tree.leaves(jres)), [x.numpy() for _, x in leaf_paths(new.resid)]))
    assert all(float(x.abs().max()) > 0 for _, x in leaf_paths(new.resid) if x.numel() > 1)  # error feedback is on
    assert max(r_err) < 1.5, names[int(np.argmax(r_err))]
    # AdamW's first step moves each parameter by about lr * sign(g), so the
    # two packages' parameters agree wherever their gradients agree in sign
    # (a quantized gradient near 0 can take either)
    close = [np.abs(np.asarray(jp) - tp.numpy()) <= 1e-6 + 1e-6 * np.abs(tp.numpy())
             for (_, tp), jp in zip(leaf_paths(new.params), jax.tree.leaves(jparams))]
    assert np.concatenate([c.reshape(-1) for c in close]).mean() > 0.99
