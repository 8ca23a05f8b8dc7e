"""The port's speculative-decoding configuration against flexflow_tpu's:
SPEC_DECODE_MODES and resolve_spec_decode on the reference's inputs,
with the same ConfigError messages; and serve_http(registry=): GET
/metrics renders the registry as the reference renders an equal one,
and answers 404 without one."""
import json
import urllib.error
import urllib.request

import pytest

pytest.importorskip("torch")

from flexflow_tpu import config as jax_config  # noqa: E402
from flexflow_tpu.obs import metrics as jax_metrics  # noqa: E402
from flexflow_tpu.serving.server import serve_http as jax_serve  # noqa: E402
from flexflow_tpu_torch import config as port_config  # noqa: E402
from flexflow_tpu_torch.obs import metrics as port_metrics  # noqa: E402
from flexflow_tpu_torch.serving import serve_http  # noqa: E402


def _error(fn, *args, **kwargs):
    """(exception type name, message) of fn(*args), or None."""
    try:
        fn(*args, **kwargs)
    except ValueError as e:
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("args,kwargs", [
    (("off", 4), {}), (("ngram", 1), {}), (("draft", 4), {"beam_size": 1}),
    (("off", 0), {"beam_size": 4}), (("medusa", 4), {}),
    (("ngram", 0), {}), (("ngram", 4), {"beam_size": 4}),
    (("draft", 4), {"beam_size": 2}), (("draft", -1), {}),
])
def test_resolve_spec_decode_as_the_reference(args, kwargs):
    want = _error(jax_config.resolve_spec_decode, *args, **kwargs)
    got = _error(port_config.resolve_spec_decode, *args, **kwargs)
    assert got == want
    if want is None:
        assert port_config.resolve_spec_decode(*args, **kwargs) == args[0]
    else:
        assert want[0] == "ConfigError"
        assert issubclass(port_config.ConfigError, ValueError)


def test_spec_modes_as_the_reference():
    assert port_config.SPEC_DECODE_MODES == jax_config.SPEC_DECODE_MODES


class _Generator:
    """The attributes serve_http's GET handlers read of an engine."""
    worker_alive = True
    batches_run = 3
    requests_done = 2

    def latency_stats(self):
        return {}

    def stats(self):
        return {}


def _fill(registry):
    registry.counter("serving/spec_rounds").inc(5)
    registry.counter("serving/spec_accepted").inc(11)
    registry.gauge("serving/kv_used_blocks").set(7)
    h = registry.histogram("serving/spec_accepted_per_round")
    for v in (1, 3, 2, 4, 1):
        h.observe(v)
    registry.histogram("serving/ttft_ms").observe(12.5, exemplar="abc")
    return registry


def _get(server, path):
    url = f"http://127.0.0.1:{server.server_address[1]}{path}"
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.headers["Content-Type"], r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read().decode()


def test_metrics_endpoint_renders_as_the_reference():
    servers = [
        serve_http(_Generator(), port=0, block=False,
                   registry=_fill(port_metrics.MetricsRegistry())),
        jax_serve(generator=_Generator(), port=0, block=False,
                  registry=_fill(jax_metrics.MetricsRegistry())),
        serve_http(_Generator(), port=0, block=False),
    ]
    try:
        got, want, bare = (_get(s, "/metrics") for s in servers)
        assert got == want
        assert got[0] == 200 and got[1].startswith("text/plain; version=0.0.4")
        assert "serving_spec_rounds 5" in got[2]
        assert bare[0] == 404 and "registry" in json.loads(bare[2])["error"]
        assert _get(servers[0], "/v2/health")[0] == 200
    finally:
        for s in servers:
            s.shutdown()
            s.server_close()
