"""Flickr8k caption CSV + split lists -> per-split path\tcaption TSVs for
English and Arabic (reference scripts/flickr/create_train_dev_list.py).
argv: captions.csv split_folder image_folder output_prefix"""
import os
import sys

def main():
    cap_file, split_folder = sys.argv[1], os.path.abspath(sys.argv[2])
    image_folder, out = os.path.abspath(sys.argv[3]), sys.argv[4]

    def read_split(name):
        with open(os.path.join(split_folder, name)) as r:
            return {x.strip() for x in r}

    splits = {
        "train": read_split("Flickr_8k.trainImages.txt"),
        "dev": read_split("Flickr_8k.devImages.txt"),
        "test": read_split("Flickr_8k.testImages.txt"),
    }
    writers = {k: open(f"{out}.{k}.en", "w") for k in splits}
    with open(cap_file) as r:
        for line in r:
            spl = line.strip().split(",")
            if spl[0] == "image":
                continue
            path = os.path.join(image_folder, spl[0])
            caption = " ".join(spl[1:])
            for k, names in splits.items():
                if spl[0] in names:
                    writers[k].write(path + "\t" + caption + "\n")
    for wtr in writers.values():
        wtr.close()

    ar_path = os.path.join(split_folder, "Flickr8k.arabic.full.txt")
    if os.path.exists(ar_path):
        writers = {k: open(f"{out}.{k}.ar", "w") for k in splits}
        with open(ar_path) as r:
            for line in r:
                spl = line.strip().split("\t")
                if spl[0] == "image":
                    continue
                name = spl[0][:-2]  # strip the #N caption index
                path = os.path.join(image_folder, name)
                caption = " ".join(spl[1:])
                for k, names in splits.items():
                    if name in names:
                        writers[k].write(path + "\t" + caption + "\n")
        for wtr in writers.values():
            wtr.close()

if __name__ == "__main__":
    main()
