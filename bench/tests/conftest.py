"""The benchmark's tests run on the CPU from the root of a checkout:
``python -m pytest -q bench/tests``.  Tests that need a card carry the
``cuda`` marker and decide inside the test."""
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "..", "src"))
sys.path.insert(0, os.path.join(HERE, ".."))
sys.path.insert(0, HERE)
