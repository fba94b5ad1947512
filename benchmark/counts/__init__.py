"""Work counted from shapes, and the card's peaks."""
