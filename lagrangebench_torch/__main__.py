"""``python -m lagrangebench_torch config=<yaml> [k=v ...]``: see ``cli.py``."""

from .cli import main

main()
