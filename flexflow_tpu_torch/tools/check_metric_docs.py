"""Static drift check (flexflow_tpu's tools/check_metric_docs.py, over
the port): every metric the port can emit under the `serving/`,
`resilience/`, `store/` or `comm/` groups must be named in
docs/OBSERVABILITY.md.

Scans flexflow_tpu_torch/ for registry call sites: `counter("...")` /
`gauge("...")` / `histogram("...")` literals (f-strings included) plus
the per-module `_count("...")` / `_observe_ms("...")` helpers whose
group prefix the module fixes, and fails listing every name the doc
does not mention.  Dynamic name segments (`{...}` in an f-string) match
the docs' `<i>`-placeholder convention (`serving/replica/<i>/queue_depth`)
or a documented wildcard family (`serving/autoscaler_*`).
tests/test_torch_tools.py runs it in tier-1, so that the port's metric
names cannot drift from the documented ones.

Usage: python -m flexflow_tpu_torch.tools.check_metric_docs [--root REPO]
(exit 0/1)
"""
from __future__ import annotations

import argparse
import os
import re
import sys
from typing import Dict, List, Set, Tuple

GROUPS = ("serving/", "resilience/", "store/", "comm/")

#: the scanned package, under --root
PACKAGE = "flexflow_tpu_torch"

#: direct registry call sites; \s* spans the line break of a wrapped
#: call like registry.gauge(\n    f"serving/replica/{id}/queue_depth"
_CALL = re.compile(
    r'\.(?:counter|gauge|histogram)\(\s*(f?)"([^"\n]+)"')

#: module-fixed helper prefix, e.g. `self.registry.counter(
#: f"store/{name}")` inside `def _count`: calls `self._count("hits")`
#: then emit store/hits
_HELPER_DEF = re.compile(
    r'\.(?:counter|histogram)\(\s*f"('
    + "|".join(g.rstrip("/") for g in GROUPS)
    + r')/\{name\}"')

_HELPER_CALL = re.compile(
    r'self\.(_count|_observe_ms)\(\s*"([^"\n]+)"')

#: a dynamic f-string segment
_DYN = re.compile(r"\{[^}]*\}")


def emitted_names(root: str) -> Dict[str, List[str]]:
    """name -> [files emitting it] for every grouped metric name the
    package can emit.  Fully dynamic leaves (`serving/{name}`: the
    helper-def pattern itself) are excluded; their concrete names come
    in through the helper-call scan."""
    out: Dict[str, List[str]] = {}
    pkg = os.path.join(root, PACKAGE)
    for dirpath, _, files in os.walk(pkg):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            rel = os.path.relpath(path, root)
            with open(path) as f:
                text = f.read()
            for is_f, name in _CALL.findall(text):
                if not name.startswith(GROUPS):
                    continue
                if is_f and _DYN.sub("", name) in GROUPS:
                    continue  # helper def: serving/{name} itself
                out.setdefault(name, []).append(rel)
            prefixes = set(_HELPER_DEF.findall(text))
            if len(prefixes) == 1:
                prefix = next(iter(prefixes))
                for _, leaf in _HELPER_CALL.findall(text):
                    out.setdefault(f"{prefix}/{leaf}", []).append(rel)
    return out


def documented_forms(doc_text: str) -> Tuple[Set[str], List[str]]:
    """(exact names incl. <i>-placeholder forms, wildcard prefixes).
    A wildcard must extend past its group prefix: the group headers
    (`serving/*`) document the namespace, not any particular metric."""
    groups = "|".join(g.rstrip("/") for g in GROUPS)
    names = set(re.findall(r"((?:" + groups + r")/[A-Za-z0-9_/<>.-]+)",
                           doc_text))
    wild = [m for m in re.findall(
                r"((?:" + groups + r")/[A-Za-z0-9_/<>.-]*)\*", doc_text)
            if m not in GROUPS]  # bare group headers don't count
    return names, wild


def is_documented(name: str, names: Set[str],
                  wild: List[str]) -> bool:
    norm = _DYN.sub("<i>", name)
    if name in names or norm in names:
        return True
    # the literal head of a templated name may fall in a documented
    # wildcard family (serving/autoscaler_{action} ~ autoscaler_*)
    head = name.split("{", 1)[0]
    return any(head.startswith(w) or (("{" in name) and w.startswith(head))
               for w in wild)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    args = p.parse_args(argv)
    doc_path = os.path.join(args.root, "docs", "OBSERVABILITY.md")
    with open(doc_path) as f:
        doc_text = f.read()
    emitted = emitted_names(args.root)
    names, wild = documented_forms(doc_text)
    missing = {n: files for n, files in sorted(emitted.items())
               if not is_documented(n, names, wild)}
    if missing:
        print(f"{len(missing)} emitted metric name(s) missing from "
              "docs/OBSERVABILITY.md:", file=sys.stderr)
        for n, files in missing.items():
            print(f"  {n}  (emitted by {', '.join(sorted(set(files)))})",
                  file=sys.stderr)
        return 1
    print(f"ok: {len(emitted)} emitted metric name(s) all documented "
          f"({len(names)} doc names, {len(wild)} wildcard families)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
