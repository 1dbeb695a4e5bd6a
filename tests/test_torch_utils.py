"""The port's profiling utilities, ablation modules, flagship entry and
synthetic example on the CPU; the ablations against
``gastx/ops/ablations.py`` with random JAX parameters, at atol 2e-5 /
rtol 1e-4 (both float32, only the order of summation differs)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gastx.ops.ablations as JA
from gastx.models import graph_statics as j_graph_statics
from gastx_torch.io import ablation_params_from_jax
from gastx_torch.models.config import graph_statics
from gastx_torch.ops import ablations as TA
from gastx_torch.utils import benchmark, capture_trace, flops_estimate, trace
from test_torch_common import ATOL, RTOL, inputs

C = 16


def _close(got, want, name=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=RTOL,
                               err_msg=name)


# -- profiling -----------------------------------------------------------------

def test_trace_is_a_named_range_under_the_profiler():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace("gastx_torch.test_range"):
            torch.ones(8) @ torch.ones(8)
    assert "gastx_torch.test_range" in {e.key for e in prof.key_averages()}


def test_capture_trace_writes_a_trace_and_none_is_a_no_op(tmp_path):
    with capture_trace(None) as prof:
        torch.ones(4).sum()
    assert prof is None and not list(tmp_path.iterdir())
    with capture_trace(str(tmp_path)):
        with trace("captured"):
            torch.ones(4).sum()
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1 and '"captured"' in files[0].read_text()


def test_benchmark_keys_are_sane():
    calls = []
    got = benchmark(lambda x: calls.append(1) or x * 2, torch.ones(16),
                    iters=5, warmup=2, items_per_call=16)
    assert len(calls) == 7
    assert set(got) == {"mean_ms", "p50_ms", "p90_ms", "items_per_s"}
    assert 0 < got["p50_ms"] <= got["p90_ms"]
    assert got["items_per_s"] == pytest.approx(16 / (got["mean_ms"] / 1e3))


def test_flops_estimate_counts_a_matmul():
    m, k, n = 8, 16, 32
    assert flops_estimate(torch.matmul, torch.ones(m, k),
                          torch.ones(k, n)) == 2 * m * n * k

    def broken(x):
        raise RuntimeError("no count")

    assert flops_estimate(broken, torch.ones(2)) is None


# -- ablations -----------------------------------------------------------------

def _bn(rng, c):
    return ({"scale": rng.uniform(0.5, 1.5, c), "bias":
             0.1 * rng.standard_normal(c)},
            {"mean": 0.1 * rng.standard_normal(c),
             "var": rng.uniform(0.5, 1.5, c)})


def _sem(rng, c_in, c_out, nnz):
    return {"W0": rng.standard_normal((c_in, c_out)) / np.sqrt(c_in),
            "W1": rng.standard_normal((c_in, c_out)) / np.sqrt(c_in),
            "e": rng.standard_normal((1, nnz)),
            "bias": 0.1 * rng.standard_normal(c_out)}


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    return np.asarray(tree, np.float32)


def _ablation(kind, seed):
    """(JAX function of (x, params, state, train, rate, rng), the port's
    module with the same random parameters, params, state)."""
    rng = np.random.default_rng(seed)
    statics = graph_statics("h36m17")
    if kind == "sem_graph_conv":
        params, state = _sem(rng, C, 24, len(statics.sym_idx)), {}
        module = TA.SemGraphConv(C, 24, statics.sym_idx, 17)

        def fn(x, p, s, train, rate, key):
            return JA.sem_graph_conv(x, p, statics.sym_idx, 17), s
    elif kind == "local_graph_simple":
        params = {"sym": _sem(rng, C, C, len(statics.sym_idx)),
                  "con": _sem(rng, C, C, len(statics.con_idx)),
                  "cat_w": rng.standard_normal((2 * C, C)) / np.sqrt(2 * C)}
        state = {}
        for name in ("bn_sym", "bn_con", "cat_bn"):
            params[name], state[name] = _bn(rng, C)
        module = TA.LocalGraphSimple(C, statics, rate=0.25)

        def fn(x, p, s, train, rate, key):
            return JA.local_graph_simple(x, p, s, j_graph_statics("h36m17"),
                                         train=train, dropout_rate=rate,
                                         rng=key)
    else:
        inter = C // 2
        params = {"theta_w": rng.standard_normal((C, inter)) / 4,
                  "phi_w": rng.standard_normal((C, inter)) / 4,
                  "g_w": rng.standard_normal((C, C)) / 4,
                  "theta_b": 0.1 * rng.standard_normal(inter),
                  "phi_b": 0.1 * rng.standard_normal(inter),
                  "g_b": 0.1 * rng.standard_normal(C),
                  "proj_theta": rng.standard_normal(inter) / 4,
                  "proj_phi": rng.standard_normal(inter) / 4,
                  "C_k": 0.1 * rng.standard_normal((17, 17))}
        params["bn"], bn_state = _bn(rng, C)
        state = {"bn": bn_state}
        module = TA.SingleGlobalGraph(C, inter, C, 17, rate=0.25)

        def fn(x, p, s, train, rate, key):
            return JA.single_global_graph(x, p, s, train=train,
                                          dropout_rate=rate, rng=key)
    params, state = _f32(params), _f32(state)
    module.load_state_dict(ablation_params_from_jax(params, state or None),
                           strict=True)
    return fn, module, params, state


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("kind", ["sem_graph_conv", "local_graph_simple",
                                  "single_global_graph"])
def test_ablation_matches_jax(kind, train, monkeypatch):
    """Each module against its JAX function: the output and, in train mode,
    the new BN running statistics, with dropout at 0.25 where the module
    has it, its masks from one numpy function in both packages; and the
    input's gradient of a random projection of the train output."""
    import gastx_torch.ops.ablations as T

    counter = [0]

    def mask(shape, rate):
        counter[0] += 1
        return np.random.default_rng(100 + counter[0]).random(shape) >= rate

    monkeypatch.setattr(JA, "_dropout", lambda x, rate, key: jnp.where(
        mask(x.shape, rate), x / (1.0 - rate), 0.0))
    monkeypatch.setattr(T, "dropout", lambda x, rate, generator: torch.where(
        torch.from_numpy(mask(tuple(x.shape), rate)), x / (1.0 - rate),
        torch.zeros(())))

    fn, module, params, state = _ablation(kind, seed=len(kind) + train)
    module.train(train)
    x = inputs((2, 5, 17, C), 3)
    rate = getattr(module, "rate", 0.0)
    want, new_state = fn(jnp.asarray(x), params, state, train, rate, None)
    counter[0] = 0
    xt = torch.from_numpy(x).requires_grad_(train)
    got = module(xt)
    _close(got, want, kind)
    for name, s in new_state.items():
        bn = {"bn_sym": "bn_1", "bn_con": "bn_2"}.get(name, name)
        _close(getattr(module, bn).running_mean, s["mean"], f"{bn} mean")
        _close(getattr(module, bn).running_var, s["var"], f"{bn} var")
    if train:
        import jax

        r = inputs(tuple(got.shape), 4)

        def proj(xj):
            counter[0] = 0
            return jnp.sum(fn(xj, params, state, True, rate, None)[0] * r)

        want_dx = jax.grad(proj)(jnp.asarray(x))
        (got * torch.from_numpy(r)).sum().backward()
        _close(xt.grad, want_dx, f"{kind} dx")


# -- the entry and the example ---------------------------------------------------

def test_entry_on_cpu_matches_the_plain_route():
    from gastx_torch.entry import entry

    fn, (model, x) = entry(device="cpu")
    y = fn(model, x)
    assert tuple(y.shape) == (8, 1, 17, 3)
    assert model.cfg.receptive_field() == 27 and model.cfg.dropout == 0.05
    torch.testing.assert_close(y, model.plain_route_forward(x), rtol=0,
                               atol=0)


def test_train_synthetic_runs_two_steps_on_cpu(capsys):
    """The example end to end at a tiny size: two steps, then the held-out
    evaluation and the gate, which two steps cannot pass."""
    from gastx_torch.examples.train_synthetic import main

    rc = main(["--steps", "2", "-ch", "8", "-b", "16", "--seqs", "2",
               "--length", "40", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "untrained held-out MPJPE" in out
    assert "epoch 1 (2 steps" in out
    assert rc == 1 and "FAIL: expected at least 3x improvement" in out
