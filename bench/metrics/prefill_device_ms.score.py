"""prefill_device_ms.score: the device ms of one member's prefill
(`serve.prefill`, between the CUDA events the span records at its start
and end on the current stream), median over the traced calls and their
members."""
from bench.spans import median_prefill_device_ms


def read(run):
    return median_prefill_device_ms(run)
