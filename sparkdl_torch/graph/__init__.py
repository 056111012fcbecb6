"""Graph ingestion & surgery — TF artifacts → torch ops on the card.

The port of ``sparkdl_tpu.graph`` (SURVEY.md 2.7/2.9/2.10, [U:
python/sparkdl/graph/]): ``TFInputGraph`` (six ingestion constructors),
``GraphFunction`` + ``IsolatedSession`` (graph surgery) and the image
converter piece. Reading an artifact needs TensorFlow on the host
(graph/reader.py makes a plain-data ``TFGraph`` of it); running it needs
only torch (graph/tf2torch.py). Importing this package imports no TF.
"""

from sparkdl_torch.graph.builder import GraphFunction, IsolatedSession
from sparkdl_torch.graph.input import TFInputGraph
from sparkdl_torch.graph.tfgraph import TFFunction, TFGraph, TFNode

__all__ = ["GraphFunction", "IsolatedSession", "TFFunction", "TFGraph",
           "TFInputGraph", "TFNode"]
