"""The port's scripts, counterparts of the reference's scripts/: the kernel
labs, the smokes (CI's gates on the CPU, multichip_smoke also on cards),
the verify launch's stage profile over the reference's candidate batch,
capture and eddsa_compare. Each runs as `python -m
handel_tpu_torch.scripts.<name>`."""
