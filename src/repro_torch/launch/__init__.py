"""repro_torch.launch — the port's services.

    python -m repro_torch.launch.compressd --addr 127.0.0.1:7733 --workers 4

:mod:`.compressd` is the compression daemon and its client, speaking the
JAX package's CPD1 protocol, so either package's client talks to either
package's daemon. Importing this package starts nothing.
"""
