"""transformer_idle_ms.infer: device-idle ms per profiled pair while the host's
main thread was inside `gt.transformer` (the embedding, the attention
blocks, the normalisation) (portbench/spans.py)."""

from portbench.spans import idle_ms


def read(run):
    return idle_ms(run, "infer", "transformer")
