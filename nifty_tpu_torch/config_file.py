"""Optimization schedules from ini-style config files (counterpart of
``nifty_tpu/config_file.py``).

Section ``base`` inheritance, repetition expansion (``2*5,3*2`` →
``5,5,2,2,2``), joining of staged ``[optimization.N]`` sections,
``*section`` references resolved through builder functions, and ``type ::
value`` coercion, turned into the arguments of the port's
:func:`~.optimize_kl.optimize_kl` (schedules as functions of the
iteration, a staged likelihood).
"""

from __future__ import annotations

import importlib
import os
from configparser import ConfigParser
from typing import Callable, Mapping

__all__ = ["OptimizeKLConfig"]


def _strtobool(s: str) -> bool:
    sl = s.strip().lower()
    if sl in ("1", "true", "yes", "on"):
        return True
    if sl in ("0", "false", "no", "off"):
        return False
    raise ValueError(f"{s!r} is not a boolean")


class OptimizeKLConfig:
    """Parse a config file into :func:`optimize_kl` arguments.

    Sections named ``[optimization.N]`` are per-stage schedules whose
    keys become per-iteration callables; other sections describe objects
    instantiated through `builders` (or a ``custom function`` entry) and
    are referenced with ``*section``.
    """

    SCHEDULE_KEYS = {
        "n samples": ("n_samples", int),
        "sample mode": ("sample_mode", str),
        "likelihood": ("likelihood", None),
    }

    def __init__(self, config_parser: ConfigParser, builders: Mapping = {}):
        if not isinstance(config_parser, ConfigParser):
            raise TypeError("config_parser must be a ConfigParser")
        self._cfg = config_parser
        self._builders = dict(builders)
        self._cache = {}
        self._interpret_base()
        self._expand_repetitions()
        self._join_stages()

    @classmethod
    def from_file(cls, file_name: str, builders: Mapping = {}):
        cfg = ConfigParser()
        cfg.optionxform = str  # case-sensitive keys
        if not os.path.isfile(file_name):
            raise RuntimeError(f"{file_name!r} not found")
        cfg.read(file_name)
        return cls(cfg, builders)

    def to_file(self, name: str):
        with open(name, "w") as f:
            self._cfg.write(f)

    # --- config transformations ---------------------------------------------

    def _interpret_base(self):
        """Fold each section's ``base = other.section`` entries in;
        explicit keys win (non-recursive, like the reference)."""
        c = self._cfg
        for section in c:
            if "base" in c[section]:
                base_name = c[section].pop("base")
                if base_name not in c:
                    raise KeyError(f"base section {base_name!r} not found")
                for k, v in c[base_name].items():
                    if k not in c[section]:
                        c[section][k] = v

    def _opt_sections(self):
        return [s for s in self._cfg if s.startswith("optimization.")]

    def _expand_repetitions(self):
        """``2*5,3*2`` → ``5,5,2,2,2``; pad with the last value up to
        ``total iterations``; ``N**section`` repeats a reference."""
        c = self._cfg
        for sname in self._opt_sections():
            sec = c[sname]
            total = sec.getint("total iterations")
            for key in sec:
                if key == "total iterations":
                    continue
                vals = []
                for item in (x.strip() for x in sec[key].split(",")):
                    if "*" not in item or item.startswith("*"):
                        vals.append(item)
                        continue
                    if "**" in item:
                        fac, ref = item.split("**", 1)
                        vals.extend(int(fac) * ["*" + ref])
                        continue
                    parts = item.split("*")
                    if len(parts) != 2:
                        raise RuntimeError(f"cannot parse repetition {item!r}")
                    fac, val = parts
                    vals.extend(int(fac) * [val])
                if len(vals) > total:
                    raise RuntimeError(
                        f"[{sname}] {key}: {len(vals)} entries exceed "
                        f"total iterations = {total}"
                    )
                vals = vals + (total - len(vals)) * [vals[-1]]
                sec[key] = ",".join(vals)

    def _join_stages(self):
        """Concatenate all ``[optimization.N]`` stages (sorted by N) into
        one ``[optimization.0]`` with summed total iterations."""
        c = self._cfg
        order = sorted(self._opt_sections(), key=lambda s: int(s.split(".")[1]))
        if not order:
            raise RuntimeError("no [optimization.N] section found")
        first = order[0]
        sec0 = c[first]
        for sname in order[1:]:
            sec = c[sname]
            for key in sec:
                if key == "total iterations":
                    sec0["total iterations"] = str(
                        sec0.getint("total iterations")
                        + sec.getint("total iterations")
                    )
                else:
                    sec0[key] = ",".join([sec0[key], sec[key]])
            del c[sname]
        if first != "optimization.0":
            c["optimization.0"] = dict(c[first])
            del c[first]

    # --- instantiation ------------------------------------------------------

    def _coerce(self, v):
        if not isinstance(v, str):
            return v
        parts = [p.strip() for p in v.split("::")]
        if len(parts) == 2:
            t, val = parts
            if t == "bool":
                return _strtobool(val)
            if t == "float":
                return float(val)
            if t == "int":
                return int(val)
            if t == "None":
                return None
        return v

    def instantiate_section(self, sec: str):
        """Build the object a section describes: resolve ``*refs``,
        coerce ``type :: value`` entries, then call the section's builder
        (from `builders`) or its ``custom function``. Cached."""
        if sec in self._cache:
            return self._cache[sec]
        if sec not in self._cfg:
            if sec in self._builders:  # builder without config entries
                out = self._builders[sec]()
                self._cache[sec] = out
                return out
            raise KeyError(f"no section or builder named {sec!r}")
        dct = dict(self._cfg[sec])
        for k, v in list(dct.items()):
            if isinstance(v, str) and len(v) > 1 and v[0] == "*":
                dct[k] = self.instantiate_section(v[1:])
        dct = {k.replace(" ", "_"): self._coerce(v) for k, v in dct.items()}
        if sec in self._builders:
            out = self._builders[sec](**dct)
        elif "custom_function" in dct:
            mod_name, func_name = dct.pop("custom_function").rsplit(".", 1)
            out = getattr(importlib.import_module(mod_name), func_name)(**dct)
        else:
            raise RuntimeError(
                f"no builder for section {sec!r} and no `custom function` entry"
            )
        self._cache[sec] = out
        return out

    def _schedule(self, key: str, dtype=None) -> Callable:
        entries = [x.strip() for x in self._cfg["optimization.0"][key].split(",")]

        def f(iteration: int):
            val = entries[iteration]
            if val.startswith("*"):
                return self.instantiate_section(val[1:])
            if val == "None":
                return None
            return dtype(val) if dtype is not None else val

        return f

    # --- drive --------------------------------------------------------------

    def __iter__(self):
        """Yield (name, value) pairs consumable by
        ``optimize_kl(**dict(self))``."""
        copt = self._cfg["optimization"] if "optimization" in self._cfg else {}
        cdyn = self._cfg["optimization.0"]
        if "output directory" in copt:
            yield "odir", copt["output directory"]
        yield "n_total_iterations", int(cdyn["total iterations"])
        for cfg_key, (arg, dtype) in self.SCHEDULE_KEYS.items():
            if cfg_key in cdyn:
                if arg == "likelihood":
                    # staged likelihoods: resolve per iteration
                    sched = self._schedule(cfg_key)
                    yield arg, sched
                else:
                    yield arg, self._schedule(cfg_key, dtype)

    def optimize_kl(self, position_or_samples, *, key, **kwargs):
        """Run :func:`~.optimize_kl.optimize_kl` as configured;
        the config is written into the output directory for provenance."""
        from .optimize_kl import optimize_kl

        dct = {**dict(self), **kwargs}
        lh = dct.pop("likelihood")
        if callable(lh) and not hasattr(lh, "energy"):
            lh = lh(0)  # staged likelihood: start with stage 0
        odir = dct.get("odir")
        if odir:
            os.makedirs(odir, exist_ok=True)
            self.to_file(os.path.join(odir, "optimization.cfg"))
        return optimize_kl(lh, position_or_samples, key=key, **dct)

    def __str__(self):
        out = []
        for sec, vals in self._cfg.items():
            out.append(f"[{sec}]")
            out.extend(f"  {k} = {v}" for k, v in vals.items())
        return "\n".join(out)
