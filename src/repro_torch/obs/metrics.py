"""Typed instrument registry behind the driver ``stats`` dict.

An :class:`Instrument` is a declared counter / gauge / info / histogram
with a unit and description; a :class:`MetricsRegistry` holds a set of
them and *is* a ``MutableMapping``, so every existing call site that
does ``stats["n_waves"] += 1`` or ``stats.get("auto_depth")`` keeps
working unchanged while the values gain a schema, exporters, and a
declared-name set.

Semantics that matter to callers:

* declared-but-unset instruments are **absent** from the mapping view —
  ``"auto_depth" in stats`` stays False until the scheduler actually
  sets it, exactly like the plain dict it replaces;
* writing an undeclared key auto-registers it as an untyped gauge
  (benchmarks run phases named ``warm``/``bench`` which create e.g.
  ``warm_pipeline_s`` keys on the fly) — the registry never throws on a
  stats write, it only *types* the keys it knows;
* ``to_stats()`` snapshots set values into a plain dict, which is what
  crosses process boundaries (``merge_process_stats`` merges those
  plain dicts byte-wise unchanged — the registry is per-process).
"""
from __future__ import annotations

from collections.abc import MutableMapping
from dataclasses import dataclass, field
import json

__all__ = ["Instrument", "MetricsRegistry", "UNSET",
           "COUNTER", "GAUGE", "INFO", "HISTOGRAM"]

COUNTER = "counter"
GAUGE = "gauge"
INFO = "info"
HISTOGRAM = "histogram"
_KINDS = (COUNTER, GAUGE, INFO, HISTOGRAM)


class _Unset:
    __slots__ = ()

    def __repr__(self):
        return "UNSET"


UNSET = _Unset()


@dataclass
class Instrument:
    """One declared metric: name + kind + unit + description + value."""

    name: str
    kind: str = GAUGE
    unit: str = ""
    desc: str = ""
    declared: bool = True
    value: object = UNSET

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown instrument kind {self.kind!r}")


class MetricsRegistry(MutableMapping):
    """Mapping-compatible typed registry (see module docstring)."""

    def __init__(self, instruments=()):
        self._ins: dict[str, Instrument] = {}
        for ins in instruments:
            self.register(ins)

    # -- declaration -------------------------------------------------------- #
    def register(self, ins: Instrument) -> Instrument:
        prev = self._ins.get(ins.name)
        if prev is not None:
            if prev.declared and ins.declared and prev.kind != ins.kind:
                raise ValueError(
                    f"instrument {ins.name!r} redeclared as {ins.kind}, "
                    f"was {prev.kind}")
            return prev
        self._ins[ins.name] = ins
        return ins

    def declared_names(self) -> set[str]:
        return {n for n, i in self._ins.items() if i.declared}

    def instruments(self) -> list[Instrument]:
        return list(self._ins.values())

    # -- mapping protocol (only SET instruments are visible) ----------------- #
    def __getitem__(self, key):
        ins = self._ins.get(key)
        if ins is None or ins.value is UNSET:
            raise KeyError(key)
        return ins.value

    def __setitem__(self, key, value):
        ins = self._ins.get(key)
        if ins is None:
            ins = self._ins[key] = Instrument(key, GAUGE, declared=False)
        ins.value = value

    def __delitem__(self, key):
        ins = self._ins.get(key)
        if ins is None or ins.value is UNSET:
            raise KeyError(key)
        ins.value = UNSET

    def __iter__(self):
        return (n for n, i in self._ins.items() if i.value is not UNSET)

    def __len__(self):
        return sum(1 for i in self._ins.values() if i.value is not UNSET)

    def __repr__(self):
        return f"MetricsRegistry({dict(self)!r})"

    # -- convenience --------------------------------------------------------- #
    def inc(self, name: str, v=1):
        ins = self._ins.get(name)
        if ins is None:
            ins = self._ins[name] = Instrument(name, COUNTER, declared=False)
        ins.value = v if ins.value is UNSET else ins.value + v
        return ins.value

    def to_stats(self) -> dict:
        """Plain-dict snapshot of set values — the thing that crosses
        process boundaries and feeds ``merge_process_stats`` unchanged."""
        return {n: i.value for n, i in self._ins.items()
                if i.value is not UNSET}

    # -- exporters ------------------------------------------------------------ #
    def export_json(self, path: str) -> str:
        doc = {n: dict(kind=i.kind, unit=i.unit, desc=i.desc,
                       declared=i.declared,
                       value=None if i.value is UNSET else i.value)
               for n, i in sorted(self._ins.items())}
        with open(path, "w") as f:
            json.dump(doc, f, indent=1, default=_jsonable)
        return path

    def export_prometheus(self, path: str) -> str:
        """Prometheus textfile-collector format: numeric counters/gauges
        as ``rads_<name>``, numeric lists as per-index labeled series,
        info/str instruments as a ``rads_info`` label set."""
        lines: list[str] = []
        info_labels: list[str] = []
        for n, ins in sorted(self._ins.items()):
            if ins.value is UNSET:
                continue
            v = ins.value
            ptype = "counter" if ins.kind == COUNTER else "gauge"
            if isinstance(v, bool):
                v = int(v)
            if isinstance(v, (int, float)):
                if ins.desc:
                    lines.append(f"# HELP rads_{n} {ins.desc}")
                lines.append(f"# TYPE rads_{n} {ptype}")
                lines.append(f"rads_{n} {float(v):g}")
            elif isinstance(v, (list, tuple)) and all(
                    isinstance(x, (int, float)) for x in v):
                lines.append(f"# TYPE rads_{n} {ptype}")
                lines.extend(f'rads_{n}{{index="{i}"}} {float(x):g}'
                             for i, x in enumerate(v))
            elif isinstance(v, dict) and all(
                    isinstance(x, (int, float)) for x in v.values()):
                lines.append(f"# TYPE rads_{n} {ptype}")
                lines.extend(f'rads_{n}{{key="{k}"}} {float(x):g}'
                             for k, x in sorted(v.items()))
            else:
                info_labels.append(f'{n}="{v}"')
        if info_labels:
            lines.append("# TYPE rads_info gauge")
            lines.append(f"rads_info{{{','.join(info_labels)}}} 1")
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        return path

    def summary(self, names) -> str:
        """Unit-aware one-liner for the launcher (replaces hand-formatted
        prints): seconds as ``1.23s``, bytes as MB, bools as on/off,
        dict instruments as ``k=v`` pairs.  Unset names are skipped."""
        parts: list[str] = []
        for n in names:
            ins = self._ins.get(n)
            if ins is None or ins.value is UNSET:
                continue
            v = ins.value
            if isinstance(v, bool):
                txt = "on" if v else "off"
            elif ins.unit == "s" and isinstance(v, (int, float)):
                txt = f"{v:.2f}s"
            elif ins.unit == "us" and isinstance(v, (int, float)):
                txt = f"{v / 1e6:.2f}s"
            elif ins.unit == "bytes" and isinstance(v, (int, float)):
                txt = f"{v / 1e6:.1f}MB"
            elif isinstance(v, float):
                txt = f"{v:.3g}"
            elif isinstance(v, dict):
                txt = " ".join(f"{k}={v[k]}" for k in sorted(v))
            else:
                txt = str(v)
            parts.append(f"{n} {txt}")
        return " | ".join(parts)


def _jsonable(x):
    try:
        import numpy as np

        if isinstance(x, np.ndarray):
            return x.tolist()
        if isinstance(x, np.generic):
            return x.item()
    except Exception:
        pass
    return float(x)
