"""repro_torch.optim's AdamW, global-norm clip and schedule against repro.optim.

The same float32 inputs from a numpy seed go through the JAX functions and
the port's over 3 steps (so that ``b1**t`` and ``b2**t`` change); every
parameter, moment, gradient and norm is held to 2 ulp. The optimizer
state's leaves carry the JAX package's checkpoint names.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as J
from repro.optim.schedule import cosine_with_warmup as jcosine
from repro_torch.core.tree import leaf_paths
from repro_torch.optim import OptState, adamw_update, clip_by_global_norm, cosine_with_warmup, init_opt

ULP = 2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ulps(a, b) -> int:
    """The largest distance in float32 units in the last place."""
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)

    return int(np.abs(ordered(a) - ordered(b)).max())


def tree(r, scale=1.0):
    """A params-like tree: matrices, a vector, a stacked list."""
    return {"a": (scale * r.standard_normal((37, 53))).astype(np.float32),
            "b": (scale * r.standard_normal(1000)).astype(np.float32),
            "c": [(scale * r.standard_normal((4, 5, 6))).astype(np.float32),
                  (scale * r.standard_normal(7)).astype(np.float32)]}


def as_jax(t):
    return jax.tree.map(jnp.asarray, t)


def as_torch(t):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), t)


def max_ulps(jt, tt) -> int:
    return max(ulps(a, b.numpy()) for a, b in zip(jax.tree.leaves(jt), [x for _, x in leaf_paths(tt)], strict=True))


def dyadic_tree(r, exponent: int):
    """Gradients ``k * 2**exponent`` with integer ``|k| <= 64``: every partial
    sum of their squares is exact in float32, so the global norm is the same
    whatever order a reduction adds them in."""
    return jax.tree.map(lambda a: (np.round(np.clip(a * 20, -64, 64)) * 2.0**exponent).astype(np.float32), tree(r))


@pytest.mark.parametrize("exponent", [-14, -3])  # norm below and above the clip
@pytest.mark.parametrize("lr", [1e-3, 3e-4])
def test_three_clipped_adamw_steps_match_jax_to_2_ulp(exponent, lr):
    """clip then AdamW, 3 steps end to end, each package on its own state."""
    r = np.random.default_rng(0)
    p = tree(r)
    jp, tp = as_jax(p), as_torch(p)
    jo, to = J.init_opt(jp), init_opt(tp)
    for step in range(3):
        g = dyadic_tree(r, exponent)
        jg, jn = J.clip_by_global_norm(as_jax(g), 1.0)
        tg, tn = clip_by_global_norm(as_torch(g), 1.0)
        assert (float(jn) < 1.0) == (exponent < -3)
        assert ulps(jn, tn.numpy()) <= ULP and max_ulps(jg, tg) <= ULP
        jp, jo = J.adamw_update(jp, jg, jo, lr)
        tp, to = adamw_update(tp, tg, to, lr)
        assert max_ulps(jp, tp) <= ULP, step
        assert max_ulps(jo.m, to.m) <= ULP and max_ulps(jo.v, to.v) <= ULP, step
        assert int(jo.step) == int(to.step) == step + 1 and to.step.dtype == torch.int32


@pytest.mark.parametrize("grad_scale", [0.01, 10.0])
def test_adamw_and_the_norm_on_random_gradients_match_jax_to_2_ulp(grad_scale):
    """Random float32 gradients: the global norm within 2 ulp (its float32
    sum of squares adds in XLA's order on one side and torch's on the
    other), and each AdamW step, given the same inputs, within 2 ulp."""
    r = np.random.default_rng(2)
    jp = as_jax(tree(r))
    jo = J.init_opt(jp)
    for step in range(3):
        g = tree(r, grad_scale)
        jg, jn = J.clip_by_global_norm(as_jax(g), 1.0)
        _, tn = clip_by_global_norm(as_torch(g), 1.0)
        assert ulps(jn, tn.numpy()) <= ULP
        to = OptState(m=as_torch(jo.m), v=as_torch(jo.v), step=torch.tensor(int(jo.step), dtype=torch.int32))
        tp, to = adamw_update(as_torch(jp), as_torch(jg), to, 1e-3)
        jp, jo = J.adamw_update(jp, jg, jo, 1e-3)
        assert max_ulps(jp, tp) <= ULP, step
        assert max_ulps(jo.m, to.m) <= ULP and max_ulps(jo.v, to.v) <= ULP, step


def test_adamw_keeps_each_parameter_dtype_and_leaves_its_inputs():
    r = np.random.default_rng(1)
    p = {"w": torch.from_numpy(r.standard_normal((8, 8)).astype(np.float32)).to(torch.bfloat16),
         "b": torch.from_numpy(r.standard_normal(8).astype(np.float32))}
    g = {"w": torch.ones(8, 8, dtype=torch.bfloat16), "b": torch.ones(8)}
    before = {k: v.clone() for k, v in p.items()}
    opt = init_opt(p)
    new_p, new_opt = adamw_update(p, g, opt, 1e-2)
    assert new_p["w"].dtype == torch.bfloat16 and new_p["b"].dtype == torch.float32
    assert new_opt.m["w"].dtype == torch.float32
    assert all(torch.equal(p[k], before[k]) for k in p) and int(opt.step) == 0
    jp = {"w": jnp.asarray(before["w"].float().numpy()).astype(jnp.bfloat16), "b": jnp.asarray(before["b"].numpy())}
    jn, _ = J.adamw_update(jp, {"w": jnp.ones((8, 8), jnp.bfloat16), "b": jnp.ones(8)}, J.init_opt(jp), 1e-2)
    assert np.array_equal(np.asarray(jn["w"]).astype(np.float32), new_p["w"].float().numpy())
    assert ulps(np.asarray(jn["b"]), new_p["b"].numpy()) <= ULP


def test_opt_state_leaf_names_are_the_jax_ones():
    params = {"embed": np.zeros((4, 2), np.float32), "stack": [{"w": np.zeros(3, np.float32)}]}
    jnames = [jax.tree_util.keystr(k, simple=True, separator="_")
              for k, _ in jax.tree_util.tree_flatten_with_path({"opt": J.init_opt(as_jax(params))})[0]]
    tnames = [n for n, _ in leaf_paths({"opt": init_opt(as_torch(params))})]
    assert tnames == jnames == ["opt_m_embed", "opt_m_stack_0_w", "opt_v_embed", "opt_v_stack_0_w", "opt_step"]
    assert isinstance(init_opt(as_torch(params)), OptState)


@pytest.mark.parametrize("kw", [{}, {"peak": 1e-3, "warmup": 10, "total": 50, "floor": 0.0}])
def test_cosine_with_warmup_matches_jax_to_2_ulp(kw):
    for step in (0, 1, 5, 9, 10, 11, 37, 50, 99, 100, 101, 4999, 10000, 20000):
        want = np.asarray(jcosine(jnp.int32(step), **kw))
        assert ulps(want, cosine_with_warmup(torch.tensor(step, dtype=torch.int32), **kw).numpy()) <= ULP, step
        assert ulps(np.asarray(jcosine(step, **kw)), cosine_with_warmup(step, **kw).numpy()) <= ULP, step
