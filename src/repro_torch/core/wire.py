"""Wire-format selection and its stats (the part of the reference's
``core/wire.py`` that the driver calls).

The codecs themselves — delta+varint ids and rows for fetchV,
Elias-Fano + run-delta pairs and bit-packed answers for verifyE — come
with the varint slice of the port (ROADMAP queue A item 7); until then
the engine speaks the ``raw`` format only and a resolved ``varint``
raises ``NotImplementedError`` where the exchange is built.
"""
from __future__ import annotations


def resolve_wire_format(requested: str, mode: str, prior: dict | None = None,
                        hysteresis: float = 0.05) -> tuple[str, str]:
    """Resolve ``wire_format="auto"`` to a concrete codec for this run.

    The driver persists one *trial* per ``(exchange mode, format)`` into
    the priors entry (``wire_trials[f"{mode}:{fmt}"] = {"pipeline_s": ...,
    "wire_bytes": ...}``, compile time already subtracted) — the measured
    bytes-vs-wall tradeoff the CPU sim needs to stop paying 3x wall for
    compression whose bytes are free intra-process.  Resolution:

    * both formats measured -> the lower ``pipeline_s`` wins, with
      ``hysteresis`` sticking to the previously recorded choice unless the
      challenger is more than that fraction faster (a stable choice keeps
      warm runs on already-persisted executables — flapping would re-trace
      fetch/verify every run);
    * one format measured -> *explore* the other (deterministic, so two
      runs complete the table);
    * nothing measured -> heuristic: transports whose bytes cost real
      time (``spmd`` collectives, ``dist`` across process boundaries)
      default to ``varint``, the intra-process reference backends to
      ``raw`` (their bytes are free, codec compute is not).

    Returns ``(format, reason)`` with reason in ``{"explicit", "measured",
    "explore", "heuristic"}`` — the driver reports it as
    ``stats["wire_auto_reason"]``."""
    if requested != "auto":
        return requested, "explicit"
    trials = (prior or {}).get("wire_trials", {})
    t = {f: trials.get(f"{mode}:{f}") for f in ("raw", "varint")}
    have = [f for f in ("raw", "varint") if t[f]]
    if len(have) == 2:
        best = min(("raw", "varint"), key=lambda f: t[f]["pipeline_s"])
        prev = (prior or {}).get("wire_choice", {}).get(mode)
        if prev in ("raw", "varint") and best != prev \
                and t[best]["pipeline_s"] >= (1.0 - hysteresis) \
                * t[prev]["pipeline_s"]:
            best = prev
        return best, "measured"
    if len(have) == 1:
        return ("varint" if have[0] == "raw" else "raw"), "explore"
    return ("varint" if mode in ("spmd", "dist") else "raw"), "heuristic"


def register_wire_metrics(reg, chosen: str, requested: str,
                          reason: str) -> None:
    """Set the wire-codec instruments on a stats registry (declared in
    :mod:`repro.obs.schema`): the format actually on the wire
    (``wire_format``), what the config asked for
    (``wire_format_requested``), why auto-selection picked it
    (``wire_auto_reason``), and the modeled compressed-fetch baseline
    accumulator (``bytes_fetch_compressed``) the per-wave stats add into."""
    reg["wire_format"] = chosen
    reg["wire_format_requested"] = requested
    reg["wire_auto_reason"] = reason
    reg["bytes_fetch_compressed"] = 0.0
