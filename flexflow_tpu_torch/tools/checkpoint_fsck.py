"""Offline two-tier checkpoint verifier (flexflow_tpu's
tools/checkpoint_fsck.py, over the port's checkpoint.py,
resilience/offload.py and store/blobstore.py).

Walks the LOCAL checkpoint directory and (with --remote) the REMOTE
mirror tier, re-checks every per-leaf crc32 manifest, validates the
`LATEST` / `REMOTE_LATEST` pointers, and reports local/remote
divergence (a step present in both tiers whose manifests disagree: the
mirror must be byte-identical to the verified local publish).

A local step is either LocalCheckpointManager's (`state.npz`, the
reference's format, checked as the reference checks it) or
CheckpointManager's (`state/`, the leaves in torch.distributed.checkpoint
files, which only the port writes): its leaves are read back through
DCP and checked against the same manifest.

Exit status is CI-friendly:

    0  every checkpoint verified, pointers intact, tiers agree
    1  corruption, a dangling pointer, or tier divergence was found
    2  usage / I/O error (directory missing, bad URI)

Usage:
    python -m flexflow_tpu_torch.tools.checkpoint_fsck CKPT_DIR
        [--remote URI] [--json]
"""
from __future__ import annotations

import argparse
import io
import json
import os
import sys
from typing import Dict, List, Optional

import numpy as np

from ..checkpoint import _STEP_DIR_RE, CheckpointManager, _leaf_crc
from ..resilience.offload import RemoteCheckpointStore
from ..store.blobstore import BlobStoreError, blobstore_from_uri


def _check_leaves(data, names, manifest: Dict, state: str,
                  problems: List[str]) -> None:
    """crc-check every manifest leaf against `data` ({key: array}, its
    keys `names`), each problem appended to `problems` as it is found."""
    leaves = manifest["leaves"]
    for key, spec in leaves.items():
        if key not in names:
            problems.append(f"leaf {key!r} in manifest but not in {state}")
            continue
        crc = _leaf_crc(data[key])
        if crc != spec.get("crc32"):
            problems.append(f"leaf {key!r} crc32 {crc:#010x} != manifest "
                            f"{spec.get('crc32')}")
    for extra in sorted(names - set(leaves)):
        problems.append(f"leaf {extra!r} in {state} but not in manifest")


def _verify_leaves(state_bytes: bytes, manifest: Dict) -> List[str]:
    """crc-check every manifest leaf against npz bytes; returns the
    list of problems (empty == verified)."""
    problems: List[str] = []
    if not isinstance(manifest.get("leaves"), dict):
        return ["manifest has no leaves table"]
    try:
        with np.load(io.BytesIO(state_bytes)) as data:
            _check_leaves(data, set(data.files), manifest, "state.npz",
                          problems)
    except Exception as e:  # torn zip/npz
        problems.append(f"state.npz undecodable: {type(e).__name__}: {e}")
    return problems


def _verify_dcp_leaves(step_dir: str, manifest: Dict) -> List[str]:
    """The same check over a CheckpointManager step's DCP leaves."""
    problems: List[str] = []
    if not isinstance(manifest.get("leaves"), dict):
        return ["manifest has no leaves table"]
    try:
        with CheckpointManager._open_leaves(step_dir) as data:
            _check_leaves(data, set(data), manifest, "state/", problems)
    except Exception as e:  # a torn or missing DCP file
        problems.append(f"state/ undecodable: {type(e).__name__}: {e}")
    return problems


def _verify_step_dir(path: str) -> List[str]:
    """meta.json, manifest.json and the leaves of one local step."""
    problems: List[str] = []
    try:
        with open(os.path.join(path, "meta.json")) as f:
            json.load(f)
    except Exception as e:
        problems.append(f"meta.json unreadable: {e}")
    manifest = None
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
    except FileNotFoundError:
        problems.append("manifest.json missing (pre-manifest "
                        "checkpoint: integrity unverifiable)")
    except Exception as e:
        problems.append(f"manifest.json unreadable: {e}")
    if manifest is None:
        return problems
    if os.path.isdir(os.path.join(path, CheckpointManager.STATE)):
        return problems + _verify_dcp_leaves(path, manifest)
    try:
        with open(os.path.join(path, "state.npz"), "rb") as f:
            state = f.read()
    except OSError as e:
        return problems + [f"state.npz unreadable: {e}"]
    return problems + _verify_leaves(state, manifest)


def fsck_local(directory: str) -> Dict:
    """Verify every local step dir + the LATEST pointer."""
    report: Dict = {"tier": "local", "directory": directory, "steps": {},
                    "latest": None, "problems": []}
    if not os.path.isdir(directory):
        report["problems"].append(f"directory {directory} does not exist")
        return report
    steps = []
    for name in sorted(os.listdir(directory)):
        m = _STEP_DIR_RE.fullmatch(name)
        if not m:
            continue
        step = int(m.group(1))
        steps.append(step)
        problems = _verify_step_dir(os.path.join(directory, name))
        report["steps"][step] = {"ok": not problems, "problems": problems}
    try:
        with open(os.path.join(directory, "LATEST")) as f:
            latest = int(f.read().strip())
        report["latest"] = latest
        entry = report["steps"].get(latest)
        if entry is None:
            report["problems"].append(
                f"LATEST pointer dangles: names step {latest} but no such "
                "step dir exists"
            )
        elif not entry["ok"]:
            report["problems"].append(
                f"LATEST pointer names step {latest}, which failed "
                "verification"
            )
    except FileNotFoundError:
        if steps:
            report["problems"].append(
                "LATEST pointer missing (directory written by pre-pointer "
                "code?)"
            )
    except ValueError as e:
        report["problems"].append(f"LATEST pointer unparseable: {e}")
    return report


def fsck_remote(uri: str) -> Dict:
    """Verify every remote mirrored step + the REMOTE_LATEST pointer."""
    report: Dict = {"tier": "remote", "uri": uri, "steps": {},
                    "latest": None, "problems": [], "manifests": {}}
    remote = RemoteCheckpointStore(blobstore_from_uri(uri))
    try:
        steps = remote.list_steps()
    except BlobStoreError as e:
        report["problems"].append(f"remote tier unlistable: {e}")
        return report
    for step in steps:
        try:
            manifest = remote.verify_step(step)
            report["steps"][step] = {"ok": True, "problems": []}
            report["manifests"][step] = manifest
        except Exception as e:
            report["steps"][step] = {"ok": False,
                                     "problems": [str(e)]}
    latest = remote.read_latest()
    report["latest"] = latest
    if latest is not None:
        entry = report["steps"].get(latest)
        if entry is None:
            report["problems"].append(
                f"REMOTE_LATEST pointer dangles: names step {latest} but "
                "no such mirrored step exists"
            )
        elif not entry["ok"]:
            report["problems"].append(
                f"REMOTE_LATEST pointer names step {latest}, which failed "
                "verification"
            )
    elif steps:
        report["problems"].append(
            "REMOTE_LATEST pointer missing/unreadable while mirrored "
            "steps exist"
        )
    return report


def diff_tiers(local_dir: str, local_rep: Dict, remote_rep: Dict
               ) -> List[str]:
    """Steps present in BOTH tiers must carry identical manifests (the
    mirror uploads the exact verified local bytes); any disagreement is
    divergence: somebody wrote one tier without the other."""
    problems: List[str] = []
    for step, remote_manifest in sorted(remote_rep["manifests"].items()):
        local_entry = local_rep["steps"].get(step)
        if local_entry is None or not local_entry["ok"]:
            continue  # nothing verified to compare against
        path = os.path.join(local_dir, f"step_{step:08d}", "manifest.json")
        try:
            with open(path) as f:
                local_manifest = json.load(f)
        except Exception:
            continue
        l_leaves = local_manifest.get("leaves", {})
        r_leaves = remote_manifest.get("leaves", {})
        if set(l_leaves) != set(r_leaves):
            problems.append(
                f"step {step}: local and remote manifests list different "
                "leaves"
            )
            continue
        for key in sorted(l_leaves):
            if l_leaves[key].get("crc32") != r_leaves[key].get("crc32"):
                problems.append(
                    f"step {step}: leaf {key!r} diverges (local crc "
                    f"{l_leaves[key].get('crc32')} != remote "
                    f"{r_leaves[key].get('crc32')})"
                )
    return problems


def _render(report: Dict) -> str:
    lines = []
    for tier in report["tiers"]:
        name = tier["tier"]
        where = tier.get("directory") or tier.get("uri")
        lines.append(f"[{name}] {where}")
        for step, entry in sorted(tier["steps"].items()):
            mark = "ok" if entry["ok"] else "CORRUPT"
            lines.append(f"  step {step:>8}  {mark}")
            for p in entry["problems"]:
                lines.append(f"      - {p}")
        pointer = "LATEST" if name == "local" else "REMOTE_LATEST"
        lines.append(f"  {pointer} = {tier['latest']}")
        for p in tier["problems"]:
            lines.append(f"  ! {p}")
    for p in report["divergence"]:
        lines.append(f"! divergence: {p}")
    lines.append("clean" if report["clean"] else "PROBLEMS FOUND")
    return "\n".join(lines) + "\n"


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("directory", help="local checkpoint directory")
    p.add_argument("--remote", default=None,
                   help="remote tier URI (file:///path or a bare path)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="emit the machine-readable report")
    args = p.parse_args(argv)

    local_rep = fsck_local(args.directory)
    if (not os.path.isdir(args.directory)) and args.remote is None:
        print(f"error: {args.directory} is not a directory",
              file=sys.stderr)
        return 2
    tiers = [local_rep]
    divergence: List[str] = []
    if args.remote is not None:
        try:
            remote_rep = fsck_remote(args.remote)
        except (ValueError, NotImplementedError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        tiers.append(remote_rep)
        divergence = diff_tiers(args.directory, local_rep, remote_rep)
        remote_rep.pop("manifests", None)  # internal to the diff

    clean = (
        not divergence
        and all(not t["problems"] for t in tiers)
        and all(e["ok"] for t in tiers for e in t["steps"].values())
    )
    report = {"tiers": tiers, "divergence": divergence, "clean": clean}
    if args.as_json:
        json.dump(report, sys.stdout, indent=2, default=str)
        sys.stdout.write("\n")
    else:
        sys.stdout.write(_render(report))
    return 0 if clean else 1


if __name__ == "__main__":
    raise SystemExit(main())
