"""``python -m repro_torch.service`` — run the control-plane daemon."""
from .server import main

main()
