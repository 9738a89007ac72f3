"""Device ms a traced step of the kernels launched inside the program's
`step.adapt` spans (the adaptation loop: the adapted window's forward,
DeYO's loss, its backward and AdamW): each kernel launched in the traced
span belongs to the stage span that holds its launch, from whatever thread
(`harness/spans.py`), over the steps whose `step` span ends in the traced
span."""
from benchmark.harness import spans


def read(run):
    return spans.stage_ms_per_step(run, "step.adapt")
