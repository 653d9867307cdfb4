"""repro_torch.checkpoint — checkpoints of torch state through the cuSZ-Hi
codec, in the JAX package's file format, on the card.

    from repro_torch import checkpoint as ckpt
    ckpt.save(state, "ckpt", step, eb=1e-3)          # compresses on the card
    state, manifest = ckpt.restore(state, "ckpt")    # tensors on the card
    saver = ckpt.AsyncCheckpointer("ckpt", eb=1e-3)  # snapshot now, save on a thread
    saver.submit(state, step); saver.close()

Every call takes ``device="cpu"`` to run without a card.
"""
from .codec import decode_tensor, encode_tensor  # noqa: F401
from .manager import AsyncCheckpointer, available_steps, latest_step, restore, save  # noqa: F401
