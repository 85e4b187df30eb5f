"""Linear player models and their condensed horizon forms."""
