"""The benchmark of tennis_torch on the card (see ``run.py``)."""
