"""Training-framework features of the port.  So far the content-addressable
checkpointer; the train step and fault supervisor come with the LM stack."""
from repro_torch.train.checkpoint import CACheckpointer  # noqa: F401
