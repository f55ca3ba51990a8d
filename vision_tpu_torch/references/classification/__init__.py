"""The classification recipe's utilities that the other trainers share."""
