"""The benchmark's own CPU tests (``python -m pytest benchmark/tests``):
the repository root on the import path, and one CPU run of the harness at
a test's size, shared by the tests that read it."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
