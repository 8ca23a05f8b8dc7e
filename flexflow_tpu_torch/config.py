"""Runtime configuration of the PyTorch port.

Counterpart of flexflow_tpu/config.py, cut to the FFConfig fields and
`from_args` flags the ported slices read: the batch size, epochs,
learning rate and weight decay, the compute dtype, the seed of the
weight init, attention's flash crossover, the paged KV-pool geometry of
the continuous engine, the replicated serving front's fields
(`serving_replicas`, the step watchdog and restart budget, retries,
`serving_handoff`, `admission_deadline_s`, `serving_chip_budget`,
`kv_transfer`, `spec_decode` and `spec_k`), the strategy search, simulator and strategy-file
fields, the multi-slice hierarchy (`slices` and the DCN fields of
topology/hierarchy.py), the fusion pass (`perform_fusion`,
`--fusion`), the strategy store (`strategy_store`,
`compilation_cache`, `remote_store`: store/, which the checkpoints'
offload tier shares), the resilience supervisor's fields (checkpoint
retention, async saves, `step_timeout`, `preempt_grace`, the restart
budget, `nan_policy`, the offload cadence, `barrier_timeout`), and
`device`, which the
reference does not have.  The field and flag names and defaults are
the reference's own, except `memory_per_device`, which is one H100's
80 GB, and `dcn_bandwidth` and `dcn_latency`, the InfiniBand NDR
figures of sim/machines/hgx_h100_16.json (a datasheet rate, 50e9 B/s
per GPU, and a model latency, 5 us), where the reference's are a TPU's
DCN.  `compilation_cache` caches the built CUDA kernel libraries, where
the reference's caches XLA executables.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional

import torch

from .fftype import ParameterSyncType

# default of FFConfig.flash_min_seq (the reference's DEFAULT_FLASH_MIN_SEQ)
DEFAULT_FLASH_MIN_SEQ = 2048

COMPUTE_DTYPES = ("float32", "bfloat16")

SEARCH_ALGOS = ("unity", "mcmc")

# FFConfig.nan_policy's values, the reference's: the supervisor's
# reaction to a non-finite loss (resilience/supervisor.py); "off" reads
# no loss for the check (check_step_health returns at once)
NAN_POLICIES = ("raise", "skip_step", "restore", "off")

# The speculative-decoding modes, the reference's: "off" = one dispatch
# per generated token; "ngram" = prompt-lookup drafts mined from the
# request's own tokens; "draft" = a smaller GPT drafting through its own
# paged decode engine.  Both verify through the verify step and accept
# greedily, so output stays token-identical to "off".  The serving
# front reads FFConfig.spec_decode / spec_k (ServingFront.from_trained).
SPEC_DECODE_MODES = ("off", "ngram", "draft")

# FFConfig.kv_transfer's values, the reference's: the fabric the front's
# handoffs stream KV blocks over, "inproc" (replicas of one process) or
# "blob" (a hop through the blob store, store/blobstore.py)
KV_TRANSFER_FABRICS = ("inproc", "blob")


class ConfigError(ValueError):
    """A configuration that can never run, raised when the engine is
    built, with the fix spelled out."""


def resolve_spec_decode(spec_decode: str, spec_k: int,
                        beam_size: int = 1) -> str:
    """Validate a speculative-decoding configuration and return the
    mode.  Verification accepts the longest greedy-matching draft
    prefix, which means nothing across beam hypotheses, so a beam
    consumer passes its beam_size and gets a ConfigError."""
    if spec_decode not in SPEC_DECODE_MODES:
        raise ConfigError(
            f"--spec-decode must be one of {SPEC_DECODE_MODES}, "
            f"got {spec_decode!r}")
    if spec_decode != "off":
        if int(spec_k) < 1:
            raise ConfigError(
                f"--spec-k must be >= 1 when --spec-decode is "
                f"{spec_decode!r}, got {spec_k}")
        if int(beam_size) > 1:
            raise ConfigError(
                f"--spec-decode {spec_decode!r} cannot be combined "
                f"with beam search (beam_size={beam_size}): "
                f"verification accepts the longest greedy-matching "
                f"draft prefix, which has no analogue across beam "
                f"hypotheses — use --spec-decode off for beam decoding")
    return spec_decode


@dataclasses.dataclass
class FFConfig:
    batch_size: int = 64
    seed: int = 0
    compute_dtype: str = "float32"

    # -- training (the reference's -e, -b, --lr, --wd)
    epochs: int = 1
    learning_rate: float = 0.01
    weight_decay: float = 1e-4
    # attention takes the flash kernels at KV length >= this (or when the
    # score tensor would pass 2 GiB); 0 forces flash everywhere.  Compile
    # stamps it on every op.
    flash_min_seq: int = DEFAULT_FLASH_MIN_SEQ
    # "cuda" (the default) or "cuda:N" runs on the card and raises when
    # there is none; "cpu" runs the ops and the kernels' plain versions
    # on the host
    device: str = "cuda"

    # -- serving: paged KV pool geometry of the continuous engine
    kv_page_size: int = 16     # tokens per KV block (must divide max_seq)
    kv_pool_blocks: int = 0    # physical blocks incl. scratch; 0 = auto
    serving_slots: int = 8     # continuous decode batch slots
    prefill_chunk: int = 8     # prompt tokens per prefill dispatch
    prefix_cache: bool = True  # copy-on-write prompt-prefix sharing
    # -- serving: the replicated front (serving/front.py), N supervised
    #    replicas behind one admission queue; the step watchdog is off
    #    at 0
    serving_replicas: int = 1
    serving_step_timeout: float = 0.0  # decode-step watchdog deadline, s
    serving_max_restarts: int = 3      # per-replica restart budget
    request_retry_limit: int = 2       # requeues before a 503 retriable
    # shed at admission when the predicted TTFT (backlog / measured
    # service rate) passes this many seconds (0 = off; a request's own
    # deadline_s overrides)
    admission_deadline_s: float = 0.0
    # chips the fleet may hold (0 = unbounded): add_replica past it is
    # refused
    serving_chip_budget: int = 0
    # the fabric a live handoff streams KV blocks over
    kv_transfer: str = "inproc"
    # speculative decoding on every replica (serving/speculative.py)
    spec_decode: str = "off"
    spec_k: int = 4
    # mid-decode handoff (serving/handoff.py): a draining, terminating
    # or rebalanced replica pauses its generations and the front resumes
    # them on another, token for token; off keeps the plain drain (every
    # slot runs to completion)
    serving_handoff: bool = False

    # -- machine resources (reference: --nodes, -ll:fsize)
    num_nodes: int = 1
    memory_per_device: int = 80_000_000_000  # one H100's HBM, bytes

    # -- strategy search (reference: --budget, --alpha, --search-algo,
    #    --enable-*-parallel, --only-data-parallel, --memory-search)
    search_budget: int = 0
    search_alpha: float = 0.05
    search_algo: str = "unity"  # "unity" (Unity DP) | "mcmc" (SysML'19)
    # MCMC propagate move: a rewrite may spread to identical ops
    search_propagate: bool = True
    # memoize revisited candidates and delta-simulate single-op moves
    # (pcg/evaluator.py); delta == full evaluation is a tested invariant
    search_eval_cache: bool = True
    # rewrite enumeration breadth of the Unity search
    rewrite_depth: int = 2
    rewrite_max_variants: int = 8
    only_data_parallel: bool = False
    enable_parameter_parallel: bool = False
    enable_attribute_parallel: bool = False
    enable_sample_parallel: bool = False
    # credit gradient sync as mostly hidden behind backward compute
    search_overlap_backward_update: bool = False
    # TASO catalog path; None = the default resolution of
    # pcg/rewrite.default_substitution_catalog, ""/"none" = off
    substitution_json: Optional[str] = None
    # time each op's forward on the card for the search's cost model;
    # None = on when the config's device is CUDA (should_calibrate)
    search_calibrate: Optional[bool] = None
    # measured (node_key -> seconds) cache; None = the default file
    # under the port's cache directory (sim/simulator.py)
    op_cost_cache_file: Optional[str] = None
    memory_search: bool = False
    memory_lambda: float = 1.0
    export_strategy_file: Optional[str] = None
    import_strategy_file: Optional[str] = None
    # the strategy store (store/): searched strategies keyed by (graph
    # signature, mesh fingerprint, simulator version) outlive the
    # process, so that a later compile restores instead of searching.
    # None = $FLEXFLOW_TPU_TORCH_STORE_DIR; ""/"none" = off.
    strategy_store: Optional[str] = None
    # the built CUDA kernel libraries' directory: a path, or "auto" =
    # <strategy store root>/kernel_cache.  None = the package's _build/.
    compilation_cache: Optional[str] = None
    # the object store of the strategy store's fleet mirror and of the
    # checkpoints' offload tier: file:///path or a bare path (gs:// and
    # s3:// need their SDKs).  None/"none" = off.
    remote_store: Optional[str] = None

    # -- simulator / machine model (reference: --machine-model-version,
    #    --machine-model-file, --simulator-segment-size)
    machine_model_version: int = 0
    machine_model_file: Optional[str] = None
    simulator_segment_size: int = 16777216

    # -- multi-slice hierarchy (topology/hierarchy.py): slices > 1 is a
    #    run over that many nodes, NVLink inside each and InfiniBand
    #    between.  The machine model becomes a SliceHierarchy, the
    #    placement (the mesh axis that spans the nodes) a searched
    #    dimension, and compile runs a two-level mesh whose grads are
    #    reduced hierarchically.  1 (the default) is the flat run.
    slices: int = 1
    dcn_bandwidth: float = 50e9   # bytes/s per GPU between slices
    dcn_latency: float = 5e-6     # seconds per hop between slices
    # the GPUs of one slice, e.g. "8" or "2x4" (only the product counts:
    # NVSwitch is flat); None = num_devices / slices
    slice_topology: Optional[str] = None
    # the simulator's grad-sync bucket (MB): a leaf's InfiniBand latency
    # term is scaled by the share of a bucket its bytes fill
    dcn_bucket_mb: float = 25.0

    # -- execution: the ZeRO stage (0-3), the mesh axis the update
    #    shards over, activation remat (every pure segment) and the
    #    gradient sync the simulator costs
    zero_stage: int = 0
    wus_axis: str = "data"
    remat: bool = False
    parameter_sync: ParameterSyncType = ParameterSyncType.ALL_REDUCE
    # the reference's --fusion (apply_fusion): fold trailing activations
    # into their linear/conv2d producers at compile
    perform_fusion: bool = False

    # -- resilience (resilience/supervisor.py, checkpoint.py): the
    #    checkpoint cadence, directory and retention, async saves, the
    #    hung-step deadline, the preemption grace, the restart budget
    #    and its backoff, and the non-finite-loss policy
    checkpoint_every: int = 0  # steps between periodic checkpoints; 0 = off
    checkpoint_dir: Optional[str] = None
    checkpoint_keep: int = 3   # keep-last-k retention
    # the step boundary waits only for the copy to the host; the write,
    # verify and publish run on a background writer
    checkpoint_async: bool = False
    # seconds the step's loss read may take (resilience/watchdog.py);
    # 0 = no watchdog
    step_timeout: float = 0.0
    # SIGTERM/SIGINT: an emergency checkpoint at the next step boundary
    preempt_grace: bool = True
    max_restarts: int = 3      # restore-and-retry budget per run
    retry_backoff: float = 0.1  # base backoff seconds (exponential, jittered)
    nan_policy: str = "raise"  # raise | skip_step | restore | off
    # the checkpoints' second tier (resilience/offload.py) mirrors every
    # offload_every-th verified step to remote_store (above), keeping
    # remote_keep steps there
    offload_every: int = 1
    remote_keep: int = 3
    # how long a preempted rank waits for the others' posts before it
    # commits the best agreement so far (distributed.preemption_barrier)
    barrier_timeout: float = 30.0

    # -- observability (obs/): trace_dir turns the telemetry on and names
    #    where trace.json and run_telemetry.jsonl land; telemetry=True
    #    records in memory without files (FFModel.telemetry).  Off (the
    #    default) makes no span on the step's hot path.
    trace_dir: Optional[str] = None
    telemetry: bool = False
    # torch.profiler over a window of fit's steps, "start:count" (e.g.
    # "3:2" profiles steps 3 and 4); needs trace_dir
    profile_steps: Optional[str] = None

    def __post_init__(self):
        if self.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(
                f"compute_dtype must be one of {COMPUTE_DTYPES}, "
                f"got {self.compute_dtype!r}")
        try:
            dev_type = torch.device(self.device).type
        except RuntimeError:
            dev_type = None
        if dev_type not in ("cuda", "cpu"):
            raise ValueError(
                f"device must be 'cuda', 'cuda:N' or 'cpu', got "
                f"{self.device!r}")
        if self.flash_min_seq < 0:
            raise ValueError(
                f"flash_min_seq must be >= 0 (0 = always flash), got "
                f"{self.flash_min_seq}")
        if self.kv_page_size < 1:
            raise ValueError(
                f"kv_page_size must be >= 1, got {self.kv_page_size}")
        if self.kv_pool_blocks < 0:
            raise ValueError(
                f"kv_pool_blocks must be >= 0 (0 = auto), "
                f"got {self.kv_pool_blocks}")
        if self.serving_slots < 1:
            raise ValueError(
                f"serving_slots must be >= 1, got {self.serving_slots}")
        if self.prefill_chunk < 0:
            raise ValueError(
                f"prefill_chunk must be >= 0 (0 = one-token prefill), "
                f"got {self.prefill_chunk}")
        if self.serving_replicas < 1:
            raise ValueError(
                f"serving_replicas must be >= 1, got {self.serving_replicas}")
        if self.serving_step_timeout < 0:
            raise ValueError(
                f"serving_step_timeout must be >= 0 (0 = watchdog off), "
                f"got {self.serving_step_timeout}")
        if self.serving_max_restarts < 0:
            raise ValueError(
                f"serving_max_restarts must be >= 0, "
                f"got {self.serving_max_restarts}")
        if self.request_retry_limit < 0:
            raise ValueError(
                f"request_retry_limit must be >= 0, "
                f"got {self.request_retry_limit}")
        if self.admission_deadline_s < 0:
            raise ValueError(
                f"admission_deadline_s must be >= 0 (0 = off), "
                f"got {self.admission_deadline_s}")
        if self.serving_chip_budget < 0:
            raise ValueError(
                f"serving_chip_budget must be >= 0 (0 = unbounded), "
                f"got {self.serving_chip_budget}")
        if self.kv_transfer not in KV_TRANSFER_FABRICS:
            raise ValueError(
                f"kv_transfer must be one of {KV_TRANSFER_FABRICS}, "
                f"got {self.kv_transfer!r}")
        if self.spec_decode not in SPEC_DECODE_MODES:
            raise ValueError(
                f"spec_decode must be one of {SPEC_DECODE_MODES}, "
                f"got {self.spec_decode!r}")
        if self.spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {self.spec_k}")
        if self.search_algo not in SEARCH_ALGOS:
            raise ValueError(f"search_algo must be one of {SEARCH_ALGOS}, "
                             f"got {self.search_algo!r}")
        if self.search_budget < 0:
            raise ValueError(
                f"search_budget must be >= 0, got {self.search_budget}")
        if self.zero_stage not in (0, 1, 2, 3):
            raise ValueError(f"zero_stage must be one of (0, 1, 2, 3), "
                             f"got {self.zero_stage!r}")
        if not self.wus_axis:
            raise ValueError("wus_axis must be a non-empty mesh axis name")
        if self.num_nodes < 1:
            raise ValueError(f"num_nodes must be >= 1, got {self.num_nodes}")
        if self.memory_per_device <= 0:
            raise ValueError(f"memory_per_device must be > 0 bytes, got "
                             f"{self.memory_per_device}")
        if self.slices < 1:
            raise ValueError(f"slices must be >= 1, got {self.slices}")
        if self.dcn_bandwidth <= 0:
            raise ValueError(f"dcn_bandwidth must be > 0 bytes/s, got "
                             f"{self.dcn_bandwidth}")
        if self.dcn_latency < 0:
            raise ValueError(f"dcn_latency must be >= 0 seconds, got "
                             f"{self.dcn_latency}")
        if self.slice_topology is not None:
            from .topology.hierarchy import parse_slice_topology

            parse_slice_topology(self.slice_topology)  # raises on a bad spec
        if self.dcn_bucket_mb <= 0:
            raise ValueError(f"dcn_bucket_mb must be > 0 MB, got "
                             f"{self.dcn_bucket_mb}")
        if self.compilation_cache is not None and not str(
                self.compilation_cache).strip():
            raise ValueError(
                "compilation_cache must be a directory path or 'auto' "
                "(None disables it)")
        if self.nan_policy not in NAN_POLICIES:
            raise ValueError(f"nan_policy must be one of {NAN_POLICIES}, "
                             f"got {self.nan_policy!r}")
        if self.checkpoint_every < 0:
            raise ValueError(f"checkpoint_every must be >= 0, got "
                             f"{self.checkpoint_every}")
        if self.checkpoint_keep < 1:
            raise ValueError(f"checkpoint_keep must be >= 1, got "
                             f"{self.checkpoint_keep}")
        if self.max_restarts < 0:
            raise ValueError(f"max_restarts must be >= 0, got "
                             f"{self.max_restarts}")
        if self.retry_backoff < 0:
            raise ValueError(f"retry_backoff must be >= 0, got "
                             f"{self.retry_backoff}")
        if self.step_timeout < 0:
            raise ValueError(f"step_timeout must be >= 0 (0 = watchdog "
                             f"off), got {self.step_timeout}")
        if self.offload_every < 1:
            raise ValueError(f"offload_every must be >= 1, got "
                             f"{self.offload_every}")
        if self.remote_keep < 1:
            raise ValueError(f"remote_keep must be >= 1, got "
                             f"{self.remote_keep}")
        if self.barrier_timeout <= 0:
            raise ValueError(f"barrier_timeout must be > 0, got "
                             f"{self.barrier_timeout}")
        if self.profile_steps is not None:
            from .obs import parse_profile_steps

            parse_profile_steps(self.profile_steps)  # raises on a bad spec
            if not self.trace_dir:
                raise ValueError(
                    "profile_steps needs trace_dir set (the torch.profiler "
                    "trace is written under it)")
        self.parameter_sync = ParameterSyncType(self.parameter_sync)

    def resolve_store_dir(self) -> Optional[str]:
        """The strategy store's root (None: the store is off), as
        store.resolve_store_dir resolves it."""
        from .store import resolve_store_dir

        return resolve_store_dir(self)

    def should_calibrate(self) -> bool:
        """search_calibrate's auto mode: measured op costs when the
        config's device is a CUDA card, the analytic roofline on the
        CPU."""
        if self.search_calibrate is not None:
            return self.search_calibrate
        return torch.device(self.device).type == "cuda"

    def resolve_num_devices(self) -> int:
        """The devices a search targets by default: the ranks of the
        torch.distributed group when there is one, else every visible
        card on CUDA, one on the CPU."""
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return dist.get_world_size()
        if torch.device(self.device).type == "cuda":
            return torch.cuda.device_count()
        return 1

    @classmethod
    def from_args(cls, argv: Optional[List[str]] = None) -> "FFConfig":
        """Parse the flags of the ported slices (the reference's names)."""
        p = argparse.ArgumentParser(add_help=False)
        p.add_argument("-e", "--epochs", type=int, default=1)
        p.add_argument("-b", "--batch-size", type=int, default=64)
        p.add_argument("--lr", "--learning-rate", dest="lr", type=float,
                       default=0.01)
        p.add_argument("--wd", "--weight-decay", dest="wd", type=float,
                       default=1e-4)
        p.add_argument("--flash-min-seq", dest="flash_min_seq", type=int,
                       default=DEFAULT_FLASH_MIN_SEQ)
        p.add_argument("--seed", type=int, default=0)
        p.add_argument("--device", type=str, default="cuda")
        p.add_argument("--kv-page-size", dest="kv_page_size", type=int,
                       default=16)
        p.add_argument("--kv-pool-blocks", dest="kv_pool_blocks",
                       type=int, default=0)
        p.add_argument("--serving-slots", dest="serving_slots", type=int,
                       default=8)
        p.add_argument("--prefill-chunk", dest="prefill_chunk",
                       type=int, default=8)
        p.add_argument("--no-prefix-cache", dest="prefix_cache",
                       action="store_false")
        p.add_argument("--serving-replicas", dest="serving_replicas",
                       type=int, default=1)
        p.add_argument("--serving-step-timeout",
                       dest="serving_step_timeout", type=float,
                       default=0.0)
        p.add_argument("--serving-max-restarts",
                       dest="serving_max_restarts", type=int, default=3)
        p.add_argument("--request-retry-limit",
                       dest="request_retry_limit", type=int, default=2)
        p.add_argument("--admission-deadline",
                       dest="admission_deadline_s", type=float,
                       default=0.0)
        p.add_argument("--serving-chip-budget",
                       dest="serving_chip_budget", type=int, default=0)
        p.add_argument("--kv-transfer", dest="kv_transfer", type=str,
                       default="inproc", choices=KV_TRANSFER_FABRICS)
        p.add_argument("--spec-decode", dest="spec_decode", type=str,
                       default="off", choices=SPEC_DECODE_MODES)
        p.add_argument("--spec-k", dest="spec_k", type=int, default=4)
        p.add_argument("--serving-handoff", dest="serving_handoff",
                       action="store_true")
        p.add_argument("--nodes", type=int, default=1)
        p.add_argument("-ll:fsize", dest="fsize_mb", type=int,
                       default=None)
        p.add_argument("--budget", "--search-budget", dest="budget",
                       type=int, default=0)
        p.add_argument("--alpha", "--search-alpha", dest="alpha",
                       type=float, default=0.05)
        p.add_argument("--no-propagate", dest="search_propagate",
                       action="store_false", default=True)
        p.add_argument("--no-search-eval-cache", dest="search_eval_cache",
                       action="store_false", default=True)
        p.add_argument("--search-algo", dest="search_algo", type=str,
                       default="unity", choices=SEARCH_ALGOS)
        p.add_argument("--only-data-parallel", action="store_true")
        p.add_argument("--enable-parameter-parallel", action="store_true")
        p.add_argument("--enable-attribute-parallel", action="store_true")
        p.add_argument("--enable-sample-parallel", action="store_true")
        p.add_argument("--search-overlap-backward-update", "--overlap",
                       dest="overlap_backward_update", action="store_true")
        p.add_argument("--parameter-sync", dest="parameter_sync", type=str,
                       default="all_reduce",
                       choices=("none", "ps", "all_reduce"))
        p.add_argument("--substitution-json", type=str, default=None)
        p.add_argument("--rewrite-depth", type=int, default=2)
        p.add_argument("--rewrite-max-variants", type=int, default=8)
        p.add_argument("--search-calibrate", dest="search_calibrate",
                       action="store_true", default=None)
        p.add_argument("--no-search-calibrate", dest="search_calibrate",
                       action="store_false")
        p.add_argument("--op-cost-cache", dest="op_cost_cache", type=str,
                       default=None)
        p.add_argument("--memory-search", action="store_true")
        p.add_argument("--machine-model-version", type=int, default=0)
        p.add_argument("--machine-model-file", type=str, default=None)
        p.add_argument("--simulator-segment-size", type=int,
                       default=16777216)
        p.add_argument("--slices", dest="slices", type=int, default=1)
        p.add_argument("--dcn-bandwidth", dest="dcn_bandwidth", type=float,
                       default=cls.dcn_bandwidth)
        p.add_argument("--dcn-latency", dest="dcn_latency", type=float,
                       default=cls.dcn_latency)
        p.add_argument("--slice-topology", dest="slice_topology", type=str,
                       default=None)
        p.add_argument("--dcn-bucket-mb", dest="dcn_bucket_mb", type=float,
                       default=25.0)
        p.add_argument("--zero-stage", dest="zero_stage", type=int,
                       default=0, choices=(0, 1, 2, 3))
        p.add_argument("--wus-axis", dest="wus_axis", type=str,
                       default="data")
        p.add_argument("--remat", action="store_true")
        p.add_argument("--fusion", action="store_true")
        p.add_argument("--export-strategy", dest="export_strategy",
                       type=str, default=None)
        p.add_argument("--import-strategy", dest="import_strategy",
                       type=str, default=None)
        p.add_argument("--strategy-store", dest="strategy_store", type=str,
                       default=None)
        p.add_argument("--no-strategy-store", dest="strategy_store",
                       action="store_const", const="none")
        p.add_argument("--compilation-cache", dest="compilation_cache",
                       type=str, nargs="?", const="auto", default=None)
        p.add_argument("--remote-store", dest="remote_store", type=str,
                       default=None)
        p.add_argument("--no-remote-store", dest="remote_store",
                       action="store_const", const="none")
        p.add_argument("--checkpoint-every", dest="checkpoint_every",
                       type=int, default=0)
        p.add_argument("--checkpoint-dir", dest="checkpoint_dir", type=str,
                       default=None)
        p.add_argument("--checkpoint-keep", dest="checkpoint_keep", type=int,
                       default=3)
        p.add_argument("--checkpoint-async", dest="checkpoint_async",
                       action="store_true")
        p.add_argument("--step-timeout", dest="step_timeout", type=float,
                       default=0.0)
        p.add_argument("--no-preempt-grace", dest="preempt_grace",
                       action="store_false", default=True)
        p.add_argument("--max-restarts", dest="max_restarts", type=int,
                       default=3)
        p.add_argument("--retry-backoff", dest="retry_backoff", type=float,
                       default=0.1)
        p.add_argument("--nan-policy", dest="nan_policy", type=str,
                       default="raise", choices=NAN_POLICIES)
        p.add_argument("--offload-every", dest="offload_every", type=int,
                       default=1)
        p.add_argument("--remote-keep", dest="remote_keep", type=int,
                       default=3)
        p.add_argument("--barrier-timeout", dest="barrier_timeout",
                       type=float, default=30.0)
        p.add_argument("--trace-dir", dest="trace_dir", type=str,
                       default=None)
        p.add_argument("--telemetry", dest="telemetry", action="store_true")
        p.add_argument("--profile-steps", dest="profile_steps", type=str,
                       default=None)
        args, _ = p.parse_known_args(argv)
        return cls(
            epochs=args.epochs,
            batch_size=args.batch_size,
            learning_rate=args.lr,
            weight_decay=args.wd,
            flash_min_seq=args.flash_min_seq,
            seed=args.seed,
            device=args.device,
            kv_page_size=args.kv_page_size,
            kv_pool_blocks=args.kv_pool_blocks,
            serving_slots=args.serving_slots,
            prefill_chunk=args.prefill_chunk,
            prefix_cache=args.prefix_cache,
            serving_replicas=args.serving_replicas,
            serving_step_timeout=args.serving_step_timeout,
            serving_max_restarts=args.serving_max_restarts,
            request_retry_limit=args.request_retry_limit,
            admission_deadline_s=args.admission_deadline_s,
            serving_chip_budget=args.serving_chip_budget,
            kv_transfer=args.kv_transfer,
            spec_decode=args.spec_decode,
            spec_k=args.spec_k,
            serving_handoff=args.serving_handoff,
            num_nodes=args.nodes,
            memory_per_device=(args.fsize_mb * 2**20 if args.fsize_mb
                               else cls.memory_per_device),
            search_budget=args.budget,
            search_alpha=args.alpha,
            search_algo=args.search_algo,
            search_propagate=args.search_propagate,
            search_eval_cache=args.search_eval_cache,
            rewrite_depth=args.rewrite_depth,
            rewrite_max_variants=args.rewrite_max_variants,
            only_data_parallel=args.only_data_parallel,
            enable_parameter_parallel=args.enable_parameter_parallel,
            enable_attribute_parallel=args.enable_attribute_parallel,
            enable_sample_parallel=args.enable_sample_parallel,
            search_overlap_backward_update=args.overlap_backward_update,
            substitution_json=args.substitution_json,
            search_calibrate=args.search_calibrate,
            op_cost_cache_file=args.op_cost_cache,
            memory_search=args.memory_search,
            export_strategy_file=args.export_strategy,
            import_strategy_file=args.import_strategy,
            strategy_store=args.strategy_store,
            compilation_cache=args.compilation_cache,
            remote_store=args.remote_store,
            machine_model_version=args.machine_model_version,
            machine_model_file=args.machine_model_file,
            simulator_segment_size=args.simulator_segment_size,
            slices=args.slices,
            dcn_bandwidth=args.dcn_bandwidth,
            dcn_latency=args.dcn_latency,
            slice_topology=args.slice_topology,
            dcn_bucket_mb=args.dcn_bucket_mb,
            zero_stage=args.zero_stage,
            wus_axis=args.wus_axis,
            remat=args.remat,
            perform_fusion=args.fusion,
            parameter_sync=ParameterSyncType(args.parameter_sync),
            checkpoint_every=args.checkpoint_every,
            checkpoint_dir=args.checkpoint_dir,
            checkpoint_keep=args.checkpoint_keep,
            checkpoint_async=args.checkpoint_async,
            step_timeout=args.step_timeout,
            preempt_grace=args.preempt_grace,
            max_restarts=args.max_restarts,
            retry_backoff=args.retry_backoff,
            nan_policy=args.nan_policy,
            offload_every=args.offload_every,
            remote_keep=args.remote_keep,
            barrier_timeout=args.barrier_timeout,
            trace_dir=args.trace_dir,
            telemetry=args.telemetry,
            profile_steps=args.profile_steps,
        )


def resolve_device(name: str) -> torch.device:
    """The torch device an FFConfig names.  A CUDA device on a machine
    without CUDA is an error: the port never carries on on the CPU
    unless the caller asked for it."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"FFConfig.device={name!r} but torch.cuda.is_available() is "
            "False: this machine has no usable CUDA device (pass "
            "device='cpu' to run on the host)")
    return dev
