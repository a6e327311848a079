from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    dumps, flatten, loads, restore, save, stored_treedef, treedef,
    unflatten,
)
