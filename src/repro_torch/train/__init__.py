"""Training-framework features of the port: the content-addressable
checkpointer, the train step and the fault supervisor."""
from repro_torch.train.checkpoint import CACheckpointer  # noqa: F401
from repro_torch.train.trainstep import make_train_step, blocked_cross_entropy  # noqa: F401
