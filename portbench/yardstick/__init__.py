"""What the work needs of the device, counted from shapes, and the card's peaks."""
