"""``tools/readings.py`` for a training cell: the same readings, with the faults of
``tools/faults_train.py`` to plant, and the cells held back from ``BENCHMARK.json``
(``tools/held.py``) among the cells. Give the program's runs the cell's whole window, so
that the judged steps fall where a run's fall; the control runs one step in its window.

    python3 benchmark/tools/readings_train.py --workload camn-train-bf16 --seeds 1,2,3 \
        [--control-seeds 4,5,6] --seconds 51 [--fault state_unchanged] [--out r.jsonl]
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from harness import common  # noqa: E402
from tools import faults, faults_train, held, readings  # noqa: E402

if __name__ == "__main__":
    faults.FAULTS.update(faults_train.FAULTS)
    load_spec = common.load_spec
    common.load_spec = lambda *a, **k: held.with_held(load_spec(*a, **k))
    sys.exit(readings.main())
