"""The unified results store: content-addressed scenario rows as JSONL.

A copy of ``repro.launch.results_store`` (no JAX in it; the port keeps its
own). Every campaign scenario (one ``run_sweep`` cell — a config run over S
seeds through the seed-stacked engine) becomes ONE JSON line keyed by the
content hash of its semantic config + seeds + dataset signature:

* rows are figure-agnostic — Fig. 3 reuses Fig. 2's SP runs, Figs. 9/10
  reuse Fig. 8's grid runs, across *and within* campaign invocations;
* rows are plain JSON (inspectable, diffable, artifact-uploadable), not
  pickles of live objects;
* the hash covers only fields that change trajectories — execution knobs
  (backend, mixing_backend, window_size, use_scan_engine, execution, and
  the port's ``device``) are recorded in the row's ``engine`` section
  instead of the key (``launch.campaign.NON_SEMANTIC_FIELDS``), so the same
  scenario hashes alike in the port and in the reference.

Append-only on disk; duplicate hashes resolve last-write-wins on load.
"""
from __future__ import annotations

import json
import os
import warnings
from typing import Any


class ResultsStore:
    """A JSONL file of scenario rows, indexed by ``spec_hash``."""

    def __init__(self, path: str):
        self.path = path
        self._rows: dict[str, dict] | None = None

    def load(self) -> dict[str, dict]:
        """Parse the file into {spec_hash: row}; missing file = empty store.

        Malformed lines (e.g. a torn final line from a run killed mid-append)
        are skipped with a warning — the scenario they held is simply re-run
        and re-appended, never a permanent wedge."""
        if self._rows is None:
            rows: dict[str, dict] = {}
            if os.path.exists(self.path):
                with open(self.path) as f:
                    for lineno, line in enumerate(f, 1):
                        line = line.strip()
                        if not line:
                            continue
                        try:
                            row = json.loads(line)
                            rows[row["spec_hash"]] = row
                        except (json.JSONDecodeError, KeyError, TypeError):
                            warnings.warn(
                                f"{self.path}:{lineno}: skipping malformed "
                                f"results-store line ({line[:60]!r}...)",
                                stacklevel=2)
            self._rows = rows
        return self._rows

    def get(self, spec_hash: str) -> dict | None:
        return self.load().get(spec_hash)

    def append(self, row: dict) -> None:
        if "spec_hash" not in row:
            raise ValueError("scenario rows must carry a spec_hash")
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path, "a") as f:
            f.write(json.dumps(row, sort_keys=True) + "\n")
        self.load()[row["spec_hash"]] = row

    def rows(self) -> list[dict]:
        return list(self.load().values())

    def __len__(self) -> int:
        return len(self.load())

    def __contains__(self, spec_hash: str) -> bool:
        return spec_hash in self.load()


def jsonable(obj: Any):
    """Recursively convert numpy scalars/arrays (and tuples) to JSON types."""
    import numpy as np

    if isinstance(obj, dict):
        return {k: jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [jsonable(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return jsonable(obj.tolist())
    if isinstance(obj, (np.floating, np.integer, np.bool_)):
        return obj.item()
    return obj
