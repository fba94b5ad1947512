"""Evaluation: image → FEN accuracy over a test set, segmentation metrics
on the board_extraction val split, and evaluation artifacts."""
