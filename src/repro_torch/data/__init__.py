"""Data pipelines (port of ``repro.data``): the synthetic LM stream.
``SyntheticClassification`` waits for the vision probe."""
from repro_torch.data.synthetic import SyntheticLM  # noqa: F401
