"""Offline RL IO: JSON-lines SampleBatch writer/reader.

Analog of the reference's offline stack (reference:
rllib/offline/json_writer.py + json_reader.py:198 — rollouts serialized
as JSON-lines of columnar batches for later off-policy training).
Arrays serialize as nested lists with dtype tags, so the files are
portable and human-inspectable; the reader yields SampleBatches ready
for DQNPolicy.learn_on_batch / TorchPolicy.learn_on_batch.

A copy of the JAX package's `rllib/offline.py`: files either package
writes, the other reads.
"""

from __future__ import annotations

import json
import os
from typing import Iterator, List, Optional

import numpy as np

from ray_tpu_torch.rllib.sample_batch import SampleBatch


class JsonWriter:
    def __init__(self, path: str, max_file_size: int = 64 * 1024 * 1024):
        self.path = path
        os.makedirs(path, exist_ok=True)
        self.max_file_size = max_file_size
        self._index = 0
        self._f = None

    def _file(self):
        if self._f is None or self._f.tell() > self.max_file_size:
            if self._f is not None:
                self._f.close()
            self._f = open(
                os.path.join(self.path, f"output-{self._index:05d}.json"), "w"
            )
            self._index += 1
        return self._f

    def write(self, batch: SampleBatch):
        row = {}
        for k, v in batch.items():
            arr = np.asarray(v)
            row[k] = {"dtype": str(arr.dtype), "data": arr.tolist()}
        f = self._file()
        f.write(json.dumps(row) + "\n")
        f.flush()

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None


class JsonReader:
    def __init__(self, path: str):
        if os.path.isdir(path):
            self.files = sorted(
                os.path.join(path, f) for f in os.listdir(path) if f.endswith(".json")
            )
        else:
            self.files = [path]
        if not self.files:
            raise FileNotFoundError(f"no offline .json files under {path}")

    def read_all(self) -> List[SampleBatch]:
        return list(self)

    def __iter__(self) -> Iterator[SampleBatch]:
        for path in self.files:
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    row = json.loads(line)
                    yield SampleBatch(
                        {
                            k: np.asarray(v["data"], dtype=v["dtype"])
                            for k, v in row.items()
                        }
                    )

    def sample(self, rng: Optional[np.random.Generator] = None) -> SampleBatch:
        rng = rng or np.random.default_rng()
        batches = self.read_all()
        return batches[int(rng.integers(0, len(batches)))]
