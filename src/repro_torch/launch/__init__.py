"""repro_torch.launch — the port's services and drivers.

    python -m repro_torch.launch.compressd --addr 127.0.0.1:7733 --workers 4
    python -m repro_torch.launch.serve --kv-compress [--compressd ADDR] [--device cpu]
    python -m repro_torch.launch.train --arch whisper-small --ckpt-eb 1e-3 [--device cpu]
    python -m torch.distributed.run --nproc-per-node 4 -m repro_torch.launch.train --mesh 2,2 [--device cpu]
    python -m repro_torch.launch.dryrun --arch yi-34b --shape train_4k [--multi-pod] | --all --both-meshes

:mod:`.compressd` is the compression daemon and its client, speaking the
JAX package's CPD1 protocol, so either package's client talks to either
package's daemon. :mod:`.serve` is the batched serving driver (prefill,
greedy decode) with the KV cache paged through the compressor.
:mod:`.train` is the training driver (the fault-tolerant Trainer, with
error-bounded checkpoints under ``--ckpt-eb``, and a device mesh under
``--mesh``); :mod:`.mesh` lays ranks out as the JAX package's meshes;
:mod:`.specs` gives every step's inputs as meta tensors; :mod:`.dryrun`
traces every cell's step at the production meshes on a fake process group.
Importing this package starts nothing.
"""
