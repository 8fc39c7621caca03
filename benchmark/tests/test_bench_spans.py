"""The span wrappers and the trace reader on tiny CPU problems."""

import torch

from benchmark import spans, trace

PORT = spans.PORT


def _tiny_loss():
    import importlib

    GP = importlib.import_module(f"{PORT}.models.problem").GPProblem
    g = torch.Generator().manual_seed(0)
    X = torch.rand(300, 4, generator=g, dtype=torch.float64)
    y = torch.sin(3 * X[:, 0]) + 0.1 * torch.randn(300, generator=g, dtype=torch.float64)
    prob = GP(kernel="gaussian", windows=[[0, 1], [2, 3]], operator="fastsum", precond="nystrom", rank=20,
              device="cpu")
    return prob.make_loss(X, y)


def test_spans_wrap_each_layer_and_restore():
    import importlib

    gp = importlib.import_module(f"{PORT}.models.gp")
    problem = importlib.import_module(f"{PORT}.models.problem")
    originals = (gp.fgmres, gp.slq_logdet, problem.gp_loss)
    loss_fn = _tiny_loss()
    log = spans.SpanLog("cpu")
    with spans.installed(log):
        assert gp.fgmres is not originals[0]
        loss, grad = loss_fn(torch.zeros(3, dtype=torch.float64))
        loss_fn(torch.zeros(3, dtype=torch.float64))
    assert (gp.fgmres, gp.slq_logdet, problem.gp_loss) == originals
    assert log.calls == {"op_build": 2, "precond": 2, "fgmres": 2, "slq": 2}
    assert all(s > 0 for s in log.seconds.values())
    plain = _tiny_loss()(torch.zeros(3, dtype=torch.float64))
    assert torch.equal(plain[0], loss) and torch.equal(plain[1], grad)


def test_captured_keeps_the_first_solve_of_each_step():
    import importlib

    gp = importlib.import_module(f"{PORT}.models.gp")
    original = gp.fgmres
    loss_fn = _tiny_loss()
    holder = [None]
    with spans.captured(holder):
        loss_fn(torch.zeros(3, dtype=torch.float64))
        first = holder[0]
        loss_fn(torch.ones(3, dtype=torch.float64))
        assert holder[0] is first
        holder[0] = None
        loss_fn(torch.ones(3, dtype=torch.float64))
    assert gp.fgmres is original
    assert first.shape == (300,) and not torch.equal(holder[0], first)


def test_a_missing_callable_is_skipped(tmp_path):
    spec = tmp_path / "spans.json"
    spec.write_text('{"wrap": [{"module": "models.gp", "attr": "no_such_solver", "span": "x"}]}')
    log = spans.SpanLog("cpu")
    with spans.installed(log, spec):
        _tiny_loss()(torch.zeros(3, dtype=torch.float64))
    assert log.calls == {}


def test_trace_labels_gaps_by_the_operation_before_them():
    work = [("a", 0, 5), ("b", 3, 8), ("c", 10, 12), ("d", 11, 12), ("e", 20, 21)]
    assert trace._merge(work) == [[0, 8, "b"], [10, 12, "d"], [20, 21, "e"]]


def test_profiled_stretch_on_the_cpu():
    out, st = trace.profiled(lambda: torch.ones(64, 64) @ torch.ones(64, 64), "cpu")
    assert out.shape == (64, 64) and st.wall_s > 0 and st.busy_s == 0.0
    assert trace.breakdown(st) == {"device_ops": [], "idle_gaps": []}
