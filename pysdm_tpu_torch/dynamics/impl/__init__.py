"""dynamics implementation helpers"""
