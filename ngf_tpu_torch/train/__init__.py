"""Training: the dense InfoInv trainer, its optimizer and ray filter."""
