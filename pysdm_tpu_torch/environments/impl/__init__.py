"""helpers shared by environments"""
