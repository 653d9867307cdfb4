"""repro_torch's compressed pod step over a real ``pod`` axis against slice 10's global view.

Four ``gloo`` ranks take one ``--compress-pods`` step on a ``(2, 1, 2)``
``("pod", "data", "model")`` mesh (mamba2-370m and olmoe-1b-7b at
``.scaled()``): each pod computes its loss and gradients on its half of
the batch over its ``("data", "model")`` sub-mesh, and the pods exchange
int8 payloads over the ``pod`` axis's process group. Every rank's exchange
is held to slice 10's global view (``steps.pod_exchange``) of both pods'
gradients and residuals as the ranks sent them: the int8 payloads and
scales equal, the averages and new residuals within 2 ulp (as
``tests/test_torch_train_pods.py`` holds them). The step as a whole is held
to the global-view step on one process (the loss, the gradients through
AdamW's first moment, the grad norm) within the family's
``MESH_LIMITS``, and keeps the state's placements, the residuals'
``(npods, ...)`` leaves sharded over ``pod`` among them.
"""
import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from repro_torch.optim import quantize_shard
from repro_torch.runtime.steps import pod_exchange
from test_torch_mesh_step import MESH_LIMITS, config
from test_torch_train_pods import ULP, ulps

ARCHS = ("mamba2-370m", "olmoe-1b-7b")
MESH = ((2, 1, 2), ("pod", "data", "model"))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_pods")
    cases = {arch: {"src": None, "arch": arch, "cfg": {}, "mesh": MESH, "pods": True,
                    "batch": ranks.step_batch(config(arch, {}))} for arch in ARCHS}
    return cases, ranks.run_steps(cases, tmp, lambda c: (1, 2))


@pytest.mark.parametrize("arch", ARCHS)
def test_every_rank_exchanges_what_the_global_view_exchanges(run, arch):
    _, out = run
    by_pod = {}
    for o in out:
        assert len(o[arch]["exchange"]) == 1  # one exchange per step
        by_pod.setdefault(o[arch]["rank_in_pod"], o[arch]["exchange"][0])
    assert sorted(by_pod) == [0, 1]
    n_leaves = len(by_pod[0][0])
    for o in out:
        g, r, avg, new_r, sent_q, sent_s = o[arch]["exchange"][0]
        p = o[arch]["rank_in_pod"]
        for i in range(n_leaves):
            gs = torch.stack([torch.from_numpy(by_pod[k][0][i]) for k in (0, 1)])
            rs = torch.stack([torch.from_numpy(by_pod[k][1][i]) for k in (0, 1)])
            want_avg, want_r, q, scale = pod_exchange(gs, rs)
            # the payload this pod's ranks quantized block by block, gathered: the global view's
            mine_q, mine_s = torch.from_numpy(sent_q[i]), sent_s[i]
            assert torch.equal(mine_q, q[p]) and mine_q.dtype == torch.int8
            assert mine_s == float(scale.reshape(-1)[p])
            assert torch.equal(quantize_shard(gs[p] + rs[p])[0], mine_q)
            terms = (q.float() * scale).abs().mean(0).numpy()
            assert ulps(avg[i], want_avg.numpy(), terms) <= ULP, (arch, i)
            assert ulps(new_r[i], want_r[p].numpy(), (gs[p] + rs[p]).abs().numpy()) <= ULP, (arch, i)


@pytest.mark.parametrize("arch", ARCHS)
def test_the_pod_step_matches_the_global_view_step(run, arch):
    cases, out = run
    cfg = config(arch, {})
    loss, gnorm, m, _, _ = ranks.reference(cases[arch], 1, 2)
    lim = MESH_LIMITS[cfg.family]
    for o in out:
        assert abs(o[arch]["loss"] - loss) < lim[0]
        assert max(ranks.rel_errors(o[arch]["m"], m)) < lim[1]
        assert abs(o[arch]["grad_norm"] - gnorm) / gnorm < lim[2]
        assert o[arch]["kept"]
