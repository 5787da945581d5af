"""fxsbench/spans.py and the readers of the program's spans on hand-made
Windows: N iterations of the schedule, each with a fill (an anchor) and a
projection of two kernels, then a replay that runs one more, and a copy.
Launches pair with device operations by order between anchors, whatever
the offset of the device's clock (operations that read as starting 12 ms
before their launches, as the card's traces read up to 10.7 ms, pair as
well as those 37 µs after them): records lost at the session's start,
a fill that trades places with the kernel beside it, or one operation lost
in mid-window leave the readings as they were; operations lost in many
stretches read None, and so does a window without spans (a program that
has none)."""
import pytest

from conftest import REPO

from fxsbench import bench, spans
from fxsbench.trace import Window

N = 300             # iterations of the schedule
LAUNCH_US = 1.0     # each launch call's host time
OP_US = 2.0         # each device operation's time
SKEW_US = 40.0      # the device's clock against the host's


def window(lose_head=0, swap_at=None, lose=(), with_spans=True,
           skew=SKEW_US):
    """Three launches before the first iteration; iteration i at T = 1000 i
    + 100: span [T, T + 90], a fill at T + 5, the projection [T + 10,
    T + 40] with kernels at T + 15 and T + 25, a kernel at T + 60; the
    replay [R, R + 300] with its iteration [R + 10, R + 200], a fill at
    R + 15, its projection [R + 20, R + 50] with a kernel at R + 25, a
    kernel at R + 100; a copy at R + 500. Operations start 3 µs after their
    launch on the host's clock plus skew. lose_head: the first
    operations lost; swap_at: the fill of that iteration starts before the
    kernel launched before it; lose: the iterations whose first projection
    kernel's operation is lost."""
    host, launched = [], []

    def launch(t, name="cudaLaunchKernel", op=None):
        host.append((name, t, t + LAUNCH_US))
        launched.append((op or f"k{len(launched)}", t + 3.0 + skew))

    for t in (10.0, 20.0, 30.0):
        launch(t)
    for i in range(N):
        t = 1000.0 * i + 100.0
        if with_spans:
            host += [("xf.iteration", t, t + 90), ("xf.projection", t + 10,
                                                    t + 40)]
        launch(t + 5, "cudaMemsetAsync", "Memset (Device)")
        if swap_at == i:
            # the fill's operation reads before the previous kernel's
            launched[-1] = (launched[-1][0], launched[-2][1] - 3.0)
        launch(t + 15, op=f"p{i}a")
        launch(t + 25, op=f"p{i}b")
        launch(t + 60)
    r = 1000.0 * N + 100.0
    if with_spans:
        host += [("xf.replay", r, r + 300), ("xf.iteration", r + 10, r + 200),
                 ("xf.projection", r + 20, r + 50)]
    launch(r + 15, "cudaMemsetAsync", "Memset (Device)")
    launch(r + 25, op="rp")
    launch(r + 100, op="rk")
    launch(r + 500, "cudaMemcpyAsync", "Memcpy DtoH (Device -> Pageable)")
    ops = [(n, s, s + OP_US) for n, s in launched[lose_head:]
           if not any(n == f"p{i}a" for i in lose)]
    ops.sort(key=lambda op: op[1])
    return Window(kernels=[op for op in ops if op[0][0] in "kpr"],
                  device_ops=ops, host_ops=host, start=min(skew, 0.0) - 100.0,
                  end=r + 2000,
                  batches=1, batch_size=2, iterations=N)


def read(name, w):
    return bench.load_reader(REPO, name)(w)


# two 2 µs kernels an iteration over 2 restarts; the replay's 3 of the
# 3 + 4 N + 4 operations of 2 µs; 90 µs an iteration less its 4 launches
N_OPS = 3 + 4 * N + 4
PROJECTION_MS = 2 * OP_US / 2 * 1e-3
HOST_MS = (90 - 4 * LAUNCH_US) * 1e-3


def test_launches_pair_with_device_ops_in_order():
    w = window()
    got = spans.pairs(w)
    assert [op for _, op in got] == w.device_ops
    ops, paired = spans.launched_in(w, "xf.projection", outside="xf.replay")
    assert paired == 1.0
    assert sorted(op[0] for op in ops) == sorted(
        f"p{i}{x}" for i in range(N) for x in "ab")
    ops, paired = spans.launched_in(w, "xf.replay")
    assert [op[0] for op in ops] == ["Memset (Device)", "rp", "rk"]


@pytest.mark.parametrize("case", ["sound", "clock", "head", "swap", "lost"])
def test_the_readers(case):
    w = window(lose_head=2 if case == "head" else 0,
               swap_at=150 if case == "swap" else None,
               lose=(77,) if case == "lost" else (),
               skew=-12000.0 if case == "clock" else SKEW_US)
    assert read("projection_ms_per_iteration", w) == pytest.approx(
        PROJECTION_MS)
    n_ops = N_OPS - {"head": 2, "lost": 1}.get(case, 0)
    assert read("replay_share", w) == pytest.approx(100.0 * 3 / n_ops)
    assert read("host_ms_per_iteration", w) == pytest.approx(HOST_MS)


def test_a_window_that_does_not_pair_reads_none():
    w = window(lose=range(0, N, 50))
    assert read("projection_ms_per_iteration", w) is None
    # the replay's stretch pairs
    assert read("replay_share", w) == pytest.approx(
        100.0 * 3 / (N_OPS - N // 50))
    # the host's time needs no pairing
    assert read("host_ms_per_iteration", w) == pytest.approx(HOST_MS)


def test_a_program_without_spans_reads_none():
    w = window(with_spans=False)
    for name in ("projection_ms_per_iteration", "replay_share",
                 "host_ms_per_iteration"):
        assert read(name, w) is None, name


def test_ranges():
    r = spans.Ranges([(5, 8), (0, 2), (1, 3)])
    assert r.starts == [0, 5] and r.ends == [3, 8]
    assert 2.5 in r and 4 not in r and 8 in r and -1 not in r
    assert r.covered(1, 6) == pytest.approx(3.0)
