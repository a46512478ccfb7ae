"""The program's span table over the window, for the metric readers.

The window is one `ModelTrainer.train` call, which marks "train" in the
table as it starts (`weasal_tpu_torch.utils.profiling`): its totals since
that mark, summed over the loop's and the batch producer's threads, are
the window's spans. So the reading holds only while no `train` call
follows the window before the result line is made, as none does in
`drivers/train_loop.py`, and no span of the program runs after it;
`tests/test_spans.py` checks the window's table against the loop's own
record of the window. (`drivers/train_loop.py` could instead sum the
window's `epoch_times` spans into the record it returns.)
A program without the table gives nothing.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional


def window_spans() -> Optional[Dict[str, Dict[str, float]]]:
    """{name: {"seconds", "self_seconds", "count"}} of the last training
    call, or None where the program has no span table or no call ran."""
    try:
        from weasal_tpu_torch.utils.profiling import span_totals
        return span_totals("train")
    except (ImportError, KeyError):
        return None


def span_ms_a_step(record: Dict, names: Iterable[str]) -> Optional[float]:
    """The seconds of the spans `names` over the window, in ms a training
    step of the window."""
    if record.get("kind") != "train" or record.get("steps", 0) <= 0:
        return None
    spans = window_spans()
    if spans is None:
        return None
    seconds = sum(spans.get(n, {}).get("seconds", 0.0) for n in names)
    return 1e3 * seconds / record["steps"]
