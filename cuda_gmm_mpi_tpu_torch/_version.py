"""Single in-package version source, dependency-free.

Kept apart from __init__ so tooling that wants the version without importing
torch can read this module (or the file) directly. Bump together with
pyproject.toml.
"""

__version__ = "0.5.0"
