"""Offline FFKV frame verifier (the reference's tools/kvframe_fsck.py,
over the port's frames: serving/kv_transfer.py writes the same bytes).

Walks a directory of dumped FFKV wire frames (or explicit frame
files) — the block streams a KVMigrator ships between replicas for
prefix migration and mid-decode handoff — and audits each one without
any engine:

  * magic / header-length / JSON header decodable, version supported;
  * schema sane: every block payload's length matches the schema's
    array shapes x dtypes;
  * per-block crc32 re-checked against the raw payload bytes;
  * token-page boundary chain: every page except the last holds
    exactly page_size tokens (only the handoff tail may be partial),
    and the declared payload lengths tile the frame exactly — no
    trailing or missing bytes.

Exit status is CI-friendly (tools/checkpoint_fsck.py's convention):

    0  every frame verified
    1  a torn, truncated, or inconsistent frame was found
    2  usage / I/O error (path missing, no frames)

Usage:
    python -m flexflow_tpu_torch.tools.kvframe_fsck PATH [PATH ...] [--json]
"""
from __future__ import annotations

import argparse
import json
import os
import struct
import sys
import zlib
from typing import Dict, List, Optional

import numpy as np

from ..serving.kv_transfer import _MAGIC, _VERSION


def fsck_frame(data: bytes) -> List[str]:
    """Audit one FFKV frame's bytes; returns the list of problems
    (empty == verified).  Mirrors unpack_kv_blocks' trust boundary
    but keeps walking past the first torn block so a report names
    EVERY problem, and additionally enforces the boundary chain the
    adopting pool relies on (full pages except an optional tail)."""
    problems: List[str] = []
    if len(data) < 8:
        return [f"frame too short for magic+header length "
                f"({len(data)} bytes)"]
    if data[:4] != _MAGIC:
        return [f"bad magic {data[:4]!r} (want {_MAGIC!r})"]
    (hlen,) = struct.unpack("<I", data[4:8])
    if len(data) < 8 + hlen:
        return [f"truncated header: {hlen} declared, "
                f"{len(data) - 8} present"]
    try:
        hdr = json.loads(data[8:8 + hlen].decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        return [f"mangled header: {type(e).__name__}: {e}"]
    if hdr.get("v") != _VERSION:
        problems.append(f"version {hdr.get('v')} != {_VERSION}")
    page = int(hdr.get("page_size", 0) or 0)
    if page < 1:
        problems.append(f"page_size {hdr.get('page_size')!r} invalid")
        return problems
    pages = hdr.get("pages")
    crcs = hdr.get("crcs")
    sizes = hdr.get("block_bytes")
    schema = hdr.get("schema")
    if not (isinstance(pages, list) and isinstance(crcs, list)
            and isinstance(sizes, list) and isinstance(schema, list)):
        problems.append("header missing pages/crcs/block_bytes/schema")
        return problems
    if not len(pages) == len(crcs) == len(sizes):
        problems.append(
            f"header tables disagree: {len(pages)} pages, "
            f"{len(crcs)} crcs, {len(sizes)} block_bytes")
        return problems
    # schema-implied payload size: each block carries every schema
    # array once, concatenated in schema order
    want_bytes = None
    try:
        want_bytes = sum(
            int(np.prod(s["shape"])) * np.dtype(s["dtype"]).itemsize
            for s in schema)
    except Exception as e:  # noqa: BLE001 — unresolvable schema
        problems.append(f"schema undecodable: {type(e).__name__}: {e}")
    # boundary chain: only the LAST page may be partial (the handoff
    # tail); an interior short page would desynchronize adoption
    for j, toks in enumerate(pages):
        if not isinstance(toks, list) or not toks:
            problems.append(f"block {j}: empty/invalid token page")
        elif len(toks) > page:
            problems.append(
                f"block {j}: {len(toks)} tokens exceed page_size "
                f"{page}")
        elif len(toks) < page and j != len(pages) - 1:
            problems.append(
                f"block {j}: interior partial page ({len(toks)} of "
                f"{page} tokens) breaks the boundary chain")
    # payload walk: crc + declared length per block, exact tiling
    off = 8 + hlen
    for j, (crc, nbytes) in enumerate(zip(crcs, sizes)):
        raw = data[off:off + int(nbytes)]
        off += int(nbytes)
        if len(raw) != int(nbytes):
            problems.append(
                f"block {j}: payload truncated ({len(raw)} of "
                f"{nbytes} bytes)")
            continue
        if want_bytes is not None and int(nbytes) != want_bytes:
            problems.append(
                f"block {j}: payload {nbytes} bytes != schema-implied "
                f"{want_bytes}")
        if zlib.crc32(raw) != crc:
            problems.append(
                f"block {j}: crc32 {zlib.crc32(raw):#010x} != header "
                f"{int(crc) & 0xFFFFFFFF:#010x}")
    if off < len(data):
        problems.append(
            f"frame has {len(data) - off} trailing byte(s) past the "
            "declared payloads")
    return problems


def fsck_paths(paths: List[str]) -> Dict:
    """Audit every .ffkv frame under the given files/directories."""
    report: Dict = {"frames": {}, "problems": []}
    files: List[str] = []
    for path in paths:
        if os.path.isdir(path):
            found = sorted(
                os.path.join(path, n) for n in os.listdir(path)
                if n.endswith(".ffkv"))
            if not found:
                report["problems"].append(
                    f"directory {path} holds no .ffkv frames")
            files.extend(found)
        elif os.path.isfile(path):
            files.append(path)
        else:
            report["problems"].append(f"path {path} does not exist")
    for fp in files:
        try:
            with open(fp, "rb") as f:
                data = f.read()
        except OSError as e:
            report["frames"][fp] = {"ok": False,
                                    "problems": [f"unreadable: {e}"]}
            continue
        problems = fsck_frame(data)
        report["frames"][fp] = {"ok": not problems, "bytes": len(data),
                                "problems": problems}
    return report


def _render(report: Dict) -> str:
    lines = []
    for fp, entry in sorted(report["frames"].items()):
        mark = "ok" if entry["ok"] else "CORRUPT"
        lines.append(f"  {fp}  {mark}")
        for p in entry["problems"]:
            lines.append(f"      - {p}")
    for p in report["problems"]:
        lines.append(f"  ! {p}")
    lines.append("clean" if report["clean"] else "PROBLEMS FOUND")
    return "\n".join(lines) + "\n"


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("paths", nargs="+",
                   help=".ffkv frame files or directories of them")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="emit the machine-readable report")
    args = p.parse_args(argv)

    if not any(os.path.exists(path) for path in args.paths):
        print(f"error: no such path(s): {', '.join(args.paths)}",
              file=sys.stderr)
        return 2
    report = fsck_paths(args.paths)
    if not report["frames"] and not report["problems"]:
        print("error: nothing to verify", file=sys.stderr)
        return 2
    report["clean"] = (
        not report["problems"]
        and bool(report["frames"])
        and all(e["ok"] for e in report["frames"].values())
    )
    if args.as_json:
        json.dump(report, sys.stdout, indent=2, default=str)
        sys.stdout.write("\n")
    else:
        sys.stdout.write(_render(report))
    return 0 if report["clean"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
