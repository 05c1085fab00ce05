"""Architecture configs available to the port."""
