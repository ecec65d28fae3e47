"""Host-side data of the port: deterministic synthetic streams and
prompts (``synthetic``), sequence packing (``packing``)."""

from repro_torch.data.packing import pack_documents  # noqa: F401
from repro_torch.data.synthetic import (  # noqa: F401
    SyntheticConfig,
    SyntheticStream,
    host_prompt,
    make_stream,
)
