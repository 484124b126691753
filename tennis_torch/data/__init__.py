"""Data layer of the port: class list and eval-stage transforms."""
