"""Scalar event records: one JSON object per logged step in
{out_dir}/events.jsonl; counterpart of lemevit_tpu/utils/events.py (its
optional wandb mirror is not ported)."""
from __future__ import annotations

import json
import os
import time
from typing import Dict


class EventWriter:
    def __init__(self, out_dir: str, enabled: bool = True):
        self.enabled = enabled
        self.path = os.path.join(out_dir, "events.jsonl")
        if enabled:
            os.makedirs(out_dir, exist_ok=True)

    def log(self, step: int, scalars: Dict[str, float]) -> None:
        if not self.enabled:
            return
        rec = {"step": int(step), "time": time.time(),
               **{k: float(v) for k, v in scalars.items()}}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
