"""Port parity: the three module loggers. `init_loggers` and `get` give
the same logger names, levels, handler kinds, file names and modes and
formatted lines as the JAX package's (the names are process-global and
shared by both packages)."""

import logging
import os

import pytest

from dynamic_vins_tpu.utils import logging as jlog
from dynamic_vins_tpu_torch.utils import logging as tlog

NAMES = ("vio", "tracker", "segmentor")


def _snapshot(loggers, out_dir):
    record = logging.LogRecord("x", logging.WARNING, __file__, 1,
                               "frame %d lost", (7,), None)
    record.created = 0.0
    record.msecs = 0.0
    snap = {}
    for name in NAMES:
        lg = loggers[name]
        hs = []
        for h in lg.handlers:
            kind = type(h).__name__
            where = os.path.relpath(h.baseFilename, out_dir) \
                if isinstance(h, logging.FileHandler) else \
                getattr(getattr(h, "stream", None), "name", None)
            hs.append((kind, where, getattr(h, "mode", None),
                       h.formatter.format(record)))
        snap[name] = (lg.name, lg.level, lg.propagate, hs)
    return snap


@pytest.fixture
def restore():
    yield
    for name in NAMES:
        lg = logging.getLogger(f"dvio.{name}")
        for h in list(lg.handlers):
            h.close()
        lg.handlers.clear()
        lg.propagate = True
        lg.setLevel(logging.NOTSET)
    jlog._LOGGERS.clear()
    tlog._LOGGERS.clear()


@pytest.mark.parametrize("console", [True, False])
def test_init_loggers_match(tmp_path, restore, console):
    kw = dict(vio_level="debug", tracker_level="warning",
              segmentor_level="nonsense", console=console)
    jd, td = tmp_path / "jax", tmp_path / "port"
    j = _snapshot(jlog.init_loggers(str(jd), **kw), str(jd))
    t = _snapshot(tlog.init_loggers(str(td), **kw), str(td))
    assert t == j
    assert t["vio"][1] == logging.DEBUG and t["segmentor"][1] == logging.INFO
    assert sorted(os.listdir(td)) == sorted(os.listdir(jd)) == \
        sorted(f"{n}.log" for n in NAMES)
    # a second init replaces the handlers (no duplicates)
    tlog.init_loggers(str(td), **kw)
    assert len(logging.getLogger("dvio.vio").handlers) == (2 if console
                                                           else 1)
    tlog.get("vio").info("written")
    for h in logging.getLogger("dvio.vio").handlers:
        h.flush()
    assert "[INFO] written" in (td / "vio.log").read_text()


def test_get_matches(restore):
    """`get` on unconfigured loggers: the process-global logger with one
    NullHandler, in either package, and no second handler after."""
    kinds = {}
    for pkg in (jlog, tlog):
        for name in NAMES:
            logging.getLogger(f"dvio.{name}").handlers.clear()
        pkg._LOGGERS.clear()
        got = {n: pkg.get(n) for n in NAMES}
        for n in NAMES:
            assert got[n] is logging.getLogger(f"dvio.{n}")
            assert pkg.get(n) is got[n]
        kinds[pkg] = {n: [type(h).__name__ for h in got[n].handlers]
                      for n in NAMES}
    assert kinds[tlog] == kinds[jlog] == {n: ["NullHandler"] for n in NAMES}
