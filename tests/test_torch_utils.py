"""The port's utilities (``libwave_tpu_torch.utils`` math, angles, io,
file, log, timing, trace; ``testing``; ``viz``) against the JAX
package's counterparts on the CPU."""

import json
import logging
import math
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libwave_tpu import testing as jtesting
from libwave_tpu.utils import angles as jangles
from libwave_tpu.utils import file as jfile
from libwave_tpu.utils import io as jio
from libwave_tpu.utils import math as jmath
from libwave_tpu_torch import testing as ttesting
from libwave_tpu_torch import viz
from libwave_tpu_torch.utils import angles, file, io, log, timing, trace
from libwave_tpu_torch.utils import math as tmath


def test_fltcmp_ties_and_threshold():
    a = [1.0, 1.0, 2.0, 1.0, 1.00005, -3.0]
    b = [1.0, 1.0001, 1.0, 2.0, 1.0, -3.0002]
    for th in (1e-4, 1e-6):
        np.testing.assert_array_equal(
            tmath.fltcmp(a, b, th).numpy(),
            np.asarray(jmath.fltcmp(jnp.asarray(a), jnp.asarray(b), th)))


@pytest.mark.parametrize("v", [[3.0, 1.0, 4.0, 1.0], [5.0, 2.0, 9.0],
                               [2.0, 2.0], [7.0]])
def test_median_even_and_odd(v):
    got = float(tmath.median(torch.tensor(v, dtype=torch.float64)))
    assert got == float(jmath.median(jnp.asarray(v)))
    assert float(tmath.median(v)) == got  # a list too


def test_vec2mat_mat2vec_column_major():
    x = np.arange(6.0)
    A = tmath.vec2mat(torch.as_tensor(x), 2, 3)
    np.testing.assert_array_equal(A.numpy(), np.asarray(jmath.vec2mat(x, 2, 3)))
    np.testing.assert_array_equal(tmath.mat2vec(A).numpy(), x)
    np.testing.assert_array_equal(tmath.mat2vec(A).numpy(),
                                  np.asarray(jmath.mat2vec(jnp.asarray(
                                      A.numpy()))))


def test_randf_randi_ranges():
    g = torch.Generator().manual_seed(0)
    f = tmath.randf(g, -2.0, 3.0, (1000,))
    i = tmath.randi(g, 4, 9, (1000,))
    assert f.min() >= -2.0 and f.max() < 3.0 and f.std() > 1.0
    assert i.min() == 4 and i.max() == 8
    g2 = torch.Generator().manual_seed(0)
    assert torch.equal(tmath.randf(g2, -2.0, 3.0, (1000,)), f)


def test_wrap_to_pi_and_two_pi():
    th = np.array([0.0, 1.0, -1.0, 3.0, -3.0, 4.0, -4.0, 7.5, -7.5, 100.0,
                   2 * math.pi, -2 * math.pi])
    np.testing.assert_allclose(angles.wrap_to_pi(torch.as_tensor(th)).numpy(),
                               np.asarray(jangles.wrap_to_pi(th)),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        angles.wrap_to_two_pi(torch.as_tensor(th)).numpy(),
        np.asarray(jangles.wrap_to_two_pi(th)), rtol=0, atol=1e-12)
    # the edges: the JAX package's code sends pi, -pi, 3 pi and -3 pi to
    # -pi (its docstring says (-pi, pi]); the port computes the same bits
    edge = np.array([math.pi, -math.pi, 3 * math.pi, -3 * math.pi,
                     2 * math.pi])
    sweep = np.linspace(-20, 20, 4001)
    for x in (edge, sweep):
        np.testing.assert_array_equal(
            angles.wrap_to_pi(torch.as_tensor(x)).numpy(),
            np.asarray(jangles.wrap_to_pi(jnp.asarray(x))))
    np.testing.assert_array_equal(angles.wrap_to_pi(
        torch.as_tensor(edge[:4])).numpy(), -math.pi)
    w = angles.wrap_to_pi(torch.as_tensor(sweep))
    assert (w >= -math.pi).all() and (w < math.pi).all()


def test_csv_round_trips(tmp_path):
    A = np.random.default_rng(0).normal(size=(5, 3))
    mine, theirs = str(tmp_path / "a.csv"), str(tmp_path / "b.csv")
    io.mat2csv(mine, A)
    jio.mat2csv(theirs, A)
    assert open(mine).read() == open(theirs).read()
    for path in (mine, theirs):
        np.testing.assert_array_equal(io.csv2mat(path), A)
        np.testing.assert_array_equal(jio.csv2mat(path), A)
        assert io.csvrows(path) == jio.csvrows(path) == 5
        assert io.csvcols(path) == jio.csvcols(path) == 3
    with open(mine) as fh:
        body = fh.read()
    hdr = str(tmp_path / "h.csv")
    with open(hdr, "w") as fh:
        fh.write("a,b,c\n" + body)
    np.testing.assert_array_equal(io.csv2mat(hdr, header=True), A)
    assert io.csvrows(hdr, header=True) == jio.csvrows(hdr, header=True)
    text = "1 2 3\n4 5 6\n"
    np.testing.assert_array_equal(io.matrix_from_string(text),
                                  jio.matrix_from_string(text))


def test_file_helpers(tmp_path):
    d = tmp_path / "x" / "y"
    d.mkdir(parents=True)
    f = d / "f.txt"
    f.write_text("1")
    for mod in (file, jfile):
        assert mod.file_exists(str(f)) and not mod.file_exists(str(d))
        assert mod.dir_exists(str(d))
    assert file.path_split("/a/b//c") == jfile.path_split("/a/b//c")
    assert file.paths_combine("/a/b", "../c/./d") == jfile.paths_combine(
        "/a/b", "../c/./d") == "/a/c/d"
    assert file.remove_dir(str(tmp_path / "x"))
    assert not file.dir_exists(str(d)) and not file.remove_dir(str(d))


def test_log_records_the_caller(capsys):
    logger = logging.getLogger("libwave_tpu_torch")
    log.log_info("hello %d", 3)
    log.log_warn("careful")
    log.log_error("bad")
    err = capsys.readouterr().err
    assert logger.handlers and logger.level == logging.INFO
    assert "[INFO] [test_torch_utils.py:" in err and "hello 3" in err
    assert "[WARNING]" in err and "[ERROR]" in err


def test_timers():
    t = timing.tic()
    time.sleep(0.02)
    assert 0.015 < timing.toc(t) < 1.0
    assert timing.mtoc(t) >= 15.0
    assert timing.time_now() >= t
    with timing.Timer() as tm:
        x = torch.ones(100) * 2
        tm.block_on({"x": x, "rest": [x, (x,)]})
    assert tm.elapsed is not None and tm.elapsed >= 0.0


def test_counters_and_profile_trace(tmp_path):
    # a span inside a profiler session, with no recording, is a profiler
    # range of its name
    with trace.profile_trace(str(tmp_path / "prof")) as prof:
        with trace.span("the_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    names = {e.key for e in prof.key_averages()}
    assert "the_region" in names
    events = json.load(open(tmp_path / "prof" / "trace.json"))
    assert any(e.get("name") == "the_region"
               for e in events["traceEvents"])


def test_testing_predicates():
    a = torch.tensor([1.0, 2.0, 3.0])
    b = a + 5e-5
    for mod in (ttesting, jtesting):
        assert mod.vectors_near(a.numpy(), b.numpy())
        assert not mod.vectors_near(a.numpy(), (a + 1e-3).numpy())
        assert mod.matrices_near(np.eye(2), np.eye(2) + 1e-5)
    assert ttesting.vectors_near(a, b) and ttesting.vectors_near_prec(a, b, 1e-4)
    ttesting.assert_vectors_near(a, b)
    with pytest.raises(AssertionError):
        ttesting.assert_matrices_near(a, a + 1.0)
    with pytest.raises(AssertionError, match="shape"):
        ttesting.assert_vectors_near(a, a[:2])
    with pytest.raises(AssertionError):
        ttesting.assert_vectors_near(a, a * float("nan"))


def test_viz_writes_pngs(tmp_path):
    pytest.importorskip("matplotlib")
    img = torch.rand(40, 60)
    xy = [torch.tensor([[5.0, 5.0], [10.0, 20.0]]),
          torch.tensor([[6.0, 7.0], [12.0, 21.0]])]
    mask = [torch.tensor([True, True]), torch.tensor([True, False])]
    out = str(tmp_path / "tracks.png")
    viz.draw_tracks(img, xy, mask, out)
    assert os.path.getsize(out) > 0
    disp = viz.PointCloudDisplay(str(tmp_path / "clouds"))
    disp.add_pointcloud(torch.rand(50, 3))
    disp.add_line([0.0, 0.0, 0.0], torch.ones(3))
    disp.render()
    disp.stop()
    assert os.listdir(tmp_path / "clouds") == ["frame_00000.png"]
