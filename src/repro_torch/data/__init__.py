"""Synthetic stand-ins for the paper's streams (counterpart of
`repro/data`); the LM token pipeline comes with the training slice."""
from repro_torch.data.streams import (TemporalStream,  # noqa: F401
                                      edge_stream, feature_stream,
                                      temporal_stream)
