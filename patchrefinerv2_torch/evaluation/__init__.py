"""Evaluation: the depth and boundary metrics and ``Tester.run``."""
