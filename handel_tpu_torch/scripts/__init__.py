"""The port's lab entry points: counterparts of the reference's scripts/."""
