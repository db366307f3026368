"""Module loggers: the three named loggers of the reference's `MyLogger`.

`vio` (backend), `tracker` (frontend) and `segmentor` (perception), each
with its own level from the run config, a file sink `<name>.log` in the
output directory and an optional console sink on stderr. The names
(`dvio.vio`, `dvio.tracker`, `dvio.segmentor`) are process-global and
the JAX package uses the same ones, so one logging config names both.
"""

from __future__ import annotations

import logging
import os
import sys

_LOGGERS = {}


def init_loggers(output_dir: str = "output",
                 vio_level: str = "info",
                 tracker_level: str = "info",
                 segmentor_level: str = "info",
                 console: bool = True):
    """(Re)configure the three loggers: old handlers are cleared, each
    gets `<output_dir>/<name>.log` (mode "w") and, with `console`, a
    stderr sink; none propagates to the root logger."""
    os.makedirs(output_dir, exist_ok=True)
    levels = {"vio": vio_level, "tracker": tracker_level,
              "segmentor": segmentor_level}
    for name, lvl in levels.items():
        lg = logging.getLogger(f"dvio.{name}")
        lg.setLevel(getattr(logging, lvl.upper(), logging.INFO))
        lg.handlers.clear()
        fh = logging.FileHandler(os.path.join(output_dir, f"{name}.log"),
                                 mode="w")
        fh.setFormatter(logging.Formatter(
            "%(asctime)s [%(levelname)s] %(message)s"))
        lg.addHandler(fh)
        if console:
            ch = logging.StreamHandler(sys.stderr)
            ch.setFormatter(logging.Formatter(
                f"[{name}] %(levelname)s %(message)s"))
            lg.addHandler(ch)
        lg.propagate = False
        _LOGGERS[name] = lg
    return _LOGGERS


def get(name: str) -> logging.Logger:
    """The vio / tracker / segmentor logger; one never configured gets a
    NullHandler."""
    if name not in _LOGGERS:
        lg = logging.getLogger(f"dvio.{name}")
        if not lg.handlers:
            lg.addHandler(logging.NullHandler())
        _LOGGERS[name] = lg
    return _LOGGERS[name]
