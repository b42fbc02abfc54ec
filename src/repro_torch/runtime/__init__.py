"""Step functions shared by the serving launcher."""
