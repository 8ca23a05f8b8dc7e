"""Helpers shared by the speculative-decoding tests of the port
(test_torch_speculative.py, test_torch_spec_engine.py): holding a new
scheduler's first admission so that both packages admit the same
requests in the same round, and the registry's serving/* metrics as a
record both packages must agree on."""
import contextlib
import threading


@contextlib.contextmanager
def held_admission(cls):
    """Hold a new scheduler's worker before its first admission until
    the block exits, so every request submitted inside is admitted in
    the same round in both packages (the worker thread would otherwise
    race the submissions)."""
    hold = threading.Event()
    admit = cls._admit

    def gated(self):
        hold.wait(30)
        admit(self)

    cls._admit = gated
    try:
        yield
    finally:
        hold.set()
        cls._admit = admit


def registry_record(reg):
    """The registry's serving/* metrics, without the tensor-parallel
    gauges the port leaves out: counters by value, gauges by value
    (spec_rounds_per_s, a rate over the host's clock, by name only),
    histograms by count, and by sum where they hold no time."""
    out = {}
    for name, m in sorted(reg._metrics.items()):
        if not name.startswith("serving/") or \
                name.startswith("serving/tp_"):
            continue
        kind = type(m).__name__
        if kind == "Histogram":
            timed = name.endswith("_ms")
            out[name] = (kind, m.count, None if timed else m.sum)
        elif name == "serving/spec_rounds_per_s":
            out[name] = (kind,)
        else:
            out[name] = (kind, m.value)
    return out
